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
arguments of the JAX functions take mesh ``Axis`` objects here
(``parallel/mesh.py``): ``axis_name`` for a depth-sharded volume,
``batch_axis_name`` for a batch split over replicas besides.
"""
from __future__ import annotations

import torch

from ..ops import one_hot
from ..parallel.collectives import pmax, psum_many

_SPATIAL = (1, 2, 3)


def _class_weights(target_volume: torch.Tensor, weight_type: str,
                   eps: float, batch_axis_name=None) -> torch.Tensor:
    """Per-(batch, class) weights, normalized by the global max (over every
    batch element: a ``pmax`` over ``batch_axis_name`` where the batch is
    split)."""
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
    wmax = weights.max()
    if batch_axis_name is not None:
        wmax = pmax(wmax, batch_axis_name)
    return weights / wmax


def dice_loss_multiclass(source: torch.Tensor, target: torch.Tensor,
                         n_class: int, weight_type: str = "Simple",
                         no_bg: bool = False, softmax: bool = False,
                         eps: float = 1e-7, axis_name=None,
                         batch_axis_name=None) -> torch.Tensor:
    """Multi-class soft dice loss.

    Args:
      source: ``(B, D, H, W, C)`` logits (``softmax=True``) or
        probabilities.
      target: ``(B, D, H, W)`` integer mask, or ``(B, D, H, W, C)``
        probabilities / one-hot.
      n_class: number of classes (C).
      axis_name: the mesh ``Axis`` a depth-sharded volume is split over:
        the per-(batch, class) volume and intersection sums are summed over
        it (differentiably) before the weights and scores, so the sharded
        loss is the global one.
      batch_axis_name: the ``Axis`` the batch is split over besides (DP x
        SP): the per-(batch, class) sums stay local, the weights' normalizer
        is a max over every element and the weighted score's numerator and
        denominator are summed over it.
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
    if axis_name is not None:
        source_volume, target_volume, intersection = psum_many(
            [source_volume, target_volume, intersection], axis_name)
    weights = _class_weights(target_volume, weight_type, eps,
                             batch_axis_name)
    scores = (2.0 * intersection + eps) / (source_volume + target_volume
                                           + 2.0 * eps)
    num, den = (weights * scores).sum(), weights.sum()
    if batch_axis_name is not None:
        num, den = psum_many([num, den], batch_axis_name)
    return 1.0 - num / den


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
