"""Dice losses.

Counterparts of ``deepatlas_tpu/losses/dice.py``:
  * ``dice_loss_multiclass`` -- the default segmentation training loss:
    softmax probabilities against one-hot targets with Uniform / Simple /
    Volume class weights and an optional background drop.
  * ``dice_loss_on_label`` -- mask-against-mask dice, the DeepAtlas anatomy
    loss between warped and fixed segmentations.
  * ``soft_dice_on_probs`` -- its differentiable form on warped one-hot
    probabilities.

Sums run over D, H, W of channel-last tensors in float32.  The mesh
arguments of the JAX functions (``axis_name``, ``batch_axis_name``) belong
to the parallel tiers and are not part of this port yet.
"""
from __future__ import annotations

import torch

from ..ops import one_hot

_SPATIAL = (1, 2, 3)


def _class_weights(target_volume: torch.Tensor, weight_type: str,
                   eps: float) -> torch.Tensor:
    """Per-(batch, class) weights, normalized by the global max."""
    if weight_type == "Simple":
        weights = 1.0 / (target_volume ** (1.0 / 3.0) + eps)
    elif weight_type == "Volume":
        weights = 1.0 / (target_volume + eps)
        finite = torch.isfinite(weights)
        max_finite = torch.where(
            finite, weights, torch.full_like(weights, float("-inf"))
        ).amax(dim=1, keepdim=True)
        weights = torch.where(finite, weights, max_finite)
    elif weight_type == "Uniform":
        weights = torch.ones_like(target_volume)
    else:
        raise ValueError(f"Class weighting type {weight_type!r} does not exist!")
    return weights / weights.max()


def dice_loss_multiclass(source: torch.Tensor, target: torch.Tensor,
                         n_class: int, weight_type: str = "Simple",
                         no_bg: bool = False, softmax: bool = False,
                         eps: float = 1e-7) -> torch.Tensor:
    """Multi-class soft dice loss.

    Args:
      source: ``(B, D, H, W, C)`` logits (``softmax=True``) or
        probabilities.
      target: ``(B, D, H, W)`` integer mask, or ``(B, D, H, W, C)``
        probabilities / one-hot.
      n_class: number of classes (C).
    """
    if softmax:
        source = torch.softmax(source, dim=-1)
    if target.dim() == source.dim() - 1:
        tgt = one_hot(target, n_class, dtype=source.dtype)
    elif target.dim() == source.dim() and target.shape[-1] == source.shape[-1]:
        tgt = target.to(source.dtype)
    else:
        raise ValueError(f"Incorrect target shape {tuple(target.shape)} for "
                         f"source {tuple(source.shape)}")
    src = source
    if no_bg:
        src = src[..., 1:]
        tgt = tgt[..., 1:]

    source_volume = src.sum(dim=_SPATIAL, dtype=torch.float32)
    target_volume = tgt.sum(dim=_SPATIAL, dtype=torch.float32)
    intersection = (src * tgt).sum(dim=_SPATIAL, dtype=torch.float32)
    weights = _class_weights(target_volume, weight_type, eps)
    scores = (2.0 * intersection + eps) / (source_volume + target_volume
                                           + 2.0 * eps)
    return 1.0 - (weights * scores).sum() / weights.sum()


def dice_loss_on_label(source: torch.Tensor, target: torch.Tensor,
                       n_class: int, weight_type: str = "Uniform",
                       eps: float = 1e-5) -> torch.Tensor:
    """Dice between two *hard* label masks ``(B, D, H, W)``, background
    excluded."""
    src = one_hot(source, n_class)[..., 1:]
    tgt = one_hot(target, n_class)[..., 1:]
    source_volume = src.sum(dim=_SPATIAL)
    target_volume = tgt.sum(dim=_SPATIAL)
    if weight_type == "Simple":
        weights = 1.0 / target_volume
        weights = torch.where(torch.isinf(weights), torch.ones_like(weights),
                              weights)
    elif weight_type == "Uniform":
        weights = torch.ones_like(target_volume)
    else:
        raise ValueError(f"Unknown weight_type {weight_type!r}")
    intersection = (src * tgt).sum(dim=_SPATIAL)
    scores = (2.0 * intersection * weights) / (
        weights * (source_volume + target_volume) + eps)
    return 1.0 - scores.mean()


def soft_dice_on_probs(source_probs: torch.Tensor, target: torch.Tensor,
                       n_class: int, eps: float = 1e-5) -> torch.Tensor:
    """Differentiable anatomy loss: dice between warped one-hot
    *probabilities* ``(B, D, H, W, C)`` and a hard target mask, background
    excluded."""
    src = source_probs[..., 1:]
    tgt = one_hot(target, n_class, dtype=source_probs.dtype)[..., 1:]
    intersection = (src * tgt).sum(dim=_SPATIAL, dtype=torch.float32)
    denom = src.sum(dim=_SPATIAL, dtype=torch.float32) + \
        tgt.sum(dim=_SPATIAL, dtype=torch.float32)
    scores = 2.0 * intersection / (denom + eps)
    return 1.0 - scores.mean()
