"""Confusion-matrix metrics, computed on the tensors' device.

One ``bincount`` over ``truth * n + pred`` gives the ``(n, n)`` confusion
matrix (exact integer counts); per-class dice is then O(n^2) arithmetic.
"""
from __future__ import annotations

import torch


def confusion_matrix(pred: torch.Tensor, truth: torch.Tensor,
                     n_class: int) -> torch.Tensor:
    """Confusion counts.

    Args:
      pred, truth: integer masks of identical shape (any rank), labels in
        ``[0, n_class)``.
      n_class: number of classes.

    Returns:
      ``(n_class, n_class)`` float32 matrix on the masks' device; entry
      [t, p] counts voxels with truth t predicted as p.
    """
    if pred.shape != truth.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and truth "
                         f"{tuple(truth.shape)} differ in shape")
    p = pred.reshape(-1).long()
    t = truth.reshape(-1).long()
    counts = torch.bincount(t * n_class + p, minlength=n_class * n_class)
    return counts[:n_class * n_class].reshape(n_class, n_class).float()


def dice_from_confusion(cm: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-class dice 2tp / (2tp + fn + fp)."""
    tp = torch.diagonal(cm)
    fn = cm.sum(dim=1) - tp
    fp = cm.sum(dim=0) - tp
    return (2 * tp) / (2 * tp + fn + fp + eps)


def multiclass_dice(pred: torch.Tensor, truth: torch.Tensor, n_class: int,
                    eps: float = 1e-11) -> torch.Tensor:
    """Per-class foreground dice (classes 1..n-1) for a batch.

    Args:
      pred, truth: ``(B, D, H, W)`` integer masks.

    Returns ``(B, n_class - 1)`` dice scores.
    """
    return torch.stack([
        dice_from_confusion(confusion_matrix(p, t, n_class), eps)[1:]
        for p, t in zip(pred, truth)])
