"""One-hot encoding of segmentation masks, channel-last.

Counterpart of ``deepatlas_tpu/ops/onehot.py``.
"""
from __future__ import annotations

import torch


def one_hot(mask: torch.Tensor, n_classes: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One-hot encode an integer mask.

    Args:
      mask: integer tensor of any shape, values in ``[0, n_classes)``; a
        value outside that range gives an all-zero row, as ``jax.nn.one_hot``
        does.
      n_classes: number of classes.

    Returns ``mask.shape + (n_classes,)`` in ``dtype``.
    """
    classes = torch.arange(n_classes, device=mask.device)
    return (mask.unsqueeze(-1) == classes).to(dtype)
