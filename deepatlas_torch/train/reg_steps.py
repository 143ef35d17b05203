"""Train / eval step factories for pairwise registration.

Counterparts of ``make_reg_train_step`` and ``make_reg_eval_step`` in
``deepatlas_tpu/train/reg_steps.py``: VoxelMorph forward, trilinear warp,
similarity (LNCC by default) + displacement regularizer, backward and one
Adam update on the state's optimizer, in place.  The joint DeepAtlas steps
of that module come with a later slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..metrics import jacobian_determinant, multiclass_dice
from ..ops import displacement_overflow, warp_labels
from .steps import TrainState


def make_reg_train_step(sim_loss: Callable, reg_loss: Callable,
                        reg_weight: float, max_disp: Optional[int] = None):
    """Returns ``(state, moving, fixed) -> (state, metrics)`` with the
    detached scalars ``loss`` (= ``sim + reg_weight * reg``), ``sim`` and
    ``reg``, both losses on float32 tensors.

    ``max_disp``: the bound the model's warp clamps displacements to; when
    given, ``metrics["disp_overflow"]`` is the fraction of voxels whose
    field exceeded it and therefore saturated."""

    def train_step(state: TrainState, moving: torch.Tensor,
                   fixed: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        disp, warped, deform = state.model(moving, fixed, train=True)
        sim = sim_loss(warped.float(), fixed.float())
        reg = reg_loss(disp.float())
        loss = sim + reg_weight * reg
        loss.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach(), "sim": sim.detach(),
                   "reg": reg.detach()}
        if max_disp is not None:
            metrics["disp_overflow"] = displacement_overflow(deform.detach(),
                                                             max_disp)
        return state, metrics

    return train_step


def make_reg_eval_step(n_class: int):
    """Returns ``(state, moving, fixed, moving_seg, fixed_seg) ->
    (per_class_dice, folding_fraction, warped)``: the moving labels warped
    with the predicted field (nearest) and their foreground dice
    ``(B, n_class - 1)`` against the fixed labels, and the fraction of
    voxels with a non-positive Jacobian determinant, on the device."""

    def eval_step(state: TrainState, moving, fixed, moving_seg, fixed_seg):
        with torch.no_grad():
            _, warped, deform = state.model(moving, fixed, train=False)
            warped_seg = warp_labels(moving_seg.long(), deform)
            dice = multiclass_dice(warped_seg, fixed_seg.long(), n_class)
            det = jacobian_determinant(deform)
            folding = (det <= 0).float().mean()
        return dice, folding, warped

    return eval_step
