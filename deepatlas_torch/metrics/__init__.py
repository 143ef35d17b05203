"""Segmentation and deformation metrics."""
from .confusion import (confusion_matrix, dice_from_confusion,
                        iou_from_confusion, metric_eval, multiclass_dice,
                        per_class_metrics, precision_from_confusion,
                        recall_from_confusion)
from .jacobian import folding_stats, jacobian_determinant

__all__ = ["confusion_matrix", "dice_from_confusion", "folding_stats",
           "iou_from_confusion", "jacobian_determinant", "metric_eval",
           "multiclass_dice", "per_class_metrics", "precision_from_confusion",
           "recall_from_confusion"]
