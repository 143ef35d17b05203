"""Segmentation and deformation metrics."""
from .confusion import (confusion_matrix, dice_from_confusion,
                        multiclass_dice)
from .jacobian import folding_stats, jacobian_determinant

__all__ = ["confusion_matrix", "dice_from_confusion", "folding_stats",
           "jacobian_determinant", "multiclass_dice"]
