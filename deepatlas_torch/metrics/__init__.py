"""Segmentation metrics."""
from .confusion import (confusion_matrix, dice_from_confusion,
                        multiclass_dice)

__all__ = ["confusion_matrix", "dice_from_confusion", "multiclass_dice"]
