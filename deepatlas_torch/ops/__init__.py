"""Tensor ops shared by the losses and the metrics."""
from .onehot import one_hot

__all__ = ["one_hot"]
