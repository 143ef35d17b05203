"""Inference and checkpoints (training comes with later slices)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .inference import (evaluate_sliding_window, make_tile_predictor,
                        sliding_window_predict, volume_dice)

__all__ = ["evaluate_sliding_window", "load_checkpoint",
           "make_tile_predictor", "save_checkpoint",
           "sliding_window_predict", "volume_dice"]
