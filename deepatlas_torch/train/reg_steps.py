"""Train / eval step factories for registration and joint DeepAtlas
training.

Counterparts of ``deepatlas_tpu/train/reg_steps.py``.  Registration:
VoxelMorph forward, trilinear warp, similarity (LNCC by default) +
displacement regularizer, backward and one Adam update on the state's
optimizer, in place.  Joint DeepAtlas (the alternating semi-supervised
scheme): a reg-phase step that trains the registration net against
similarity, smoothness and anatomy consistency with the frozen seg net
filling in missing labels, and a seg-phase step that trains the seg net
against the supervised loss and anatomy consistency through the frozen reg
net's warp.  Label flags are host tensors (from the batch's names), so
which branch a step takes is decided on the host, with no device sync.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels.anatomy import hard_anatomy_dice
from ..kernels.warp import splat_trilinear
from ..losses import soft_dice_on_probs
from ..metrics import jacobian_determinant, multiclass_dice
from ..ops import (clamp_displacement, displacement_overflow, grid_sample,
                   one_hot, warp_labels)
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


def _labels_or_prediction(seg_state: TrainState, has_label: torch.Tensor,
                          gt_seg: torch.Tensor, images: torch.Tensor):
    """Ground-truth labels where ``has_label`` (a host ``(B,)`` bool
    tensor), the frozen seg net's argmax (eval-mode BatchNorm, no gradient)
    elsewhere; a fully labelled side runs no seg forward."""
    gt = gt_seg.long()
    if bool(has_label.all()):
        return gt
    with torch.no_grad():
        pred = seg_state.model(images, train=False).argmax(dim=-1)
    mask = has_label.to(pred.device)[:, None, None, None]
    return torch.where(mask, gt, pred)


def make_joint_reg_step(sim_loss: Callable, reg_loss: Callable,
                        reg_weight: float, anatomy_weight: float,
                        n_class: int, warp_fn: Callable = grid_sample,
                        anatomy_dtype: Optional[torch.dtype] = None,
                        max_disp: Optional[int] = None,
                        fused_anatomy: bool = False):
    """Reg-phase step of joint training: updates the reg net against
    ``sim + reg_weight * reg + anatomy_weight * anatomy``; the anatomy is
    the dice of the moving labels warped onto the fixed ones, each side's
    missing labels replaced by the frozen seg net's prediction.

    ``fused_anatomy=True`` computes the anatomy on the matched-label kernels
    (``kernels.hard_anatomy_dice`` with ``fused_grad``: one C = 1 gather
    with its derivative planes, one splat of ones), which needs
    ``max_disp``; otherwise ``warp_fn(one_hot(lab_m), deform)`` warps the
    ``anatomy_dtype`` one-hot (float32 by default) and
    ``soft_dice_on_probs`` takes its dice.  The deformation stays float32.

    Returns ``(reg_state, seg_state, moving, fixed, moving_seg, fixed_seg,
    moving_has_label, fixed_has_label) -> (reg_state, metrics)`` with the
    detached scalars ``loss``, ``sim``, ``reg``, ``anatomy`` and, with
    ``max_disp``, ``disp_overflow``."""
    if fused_anatomy and max_disp is None:
        raise ValueError("fused_anatomy requires max_disp (the matched-label "
                         "anatomy clamps the field first)")

    def step(reg_state: TrainState, seg_state: TrainState, moving, fixed,
             moving_seg, fixed_seg, moving_has_label, fixed_has_label):
        lab_m = _labels_or_prediction(seg_state, moving_has_label,
                                      moving_seg, moving)
        lab_f = _labels_or_prediction(seg_state, fixed_has_label, fixed_seg,
                                      fixed)
        reg_state.optimizer.zero_grad(set_to_none=True)
        disp, warped, deform = reg_state.model(moving, fixed, train=True)
        sim = sim_loss(warped.float(), fixed.float())
        reg = reg_loss(disp.float())
        if fused_anatomy:
            anat = hard_anatomy_dice(lab_m, lab_f, deform, n_class,
                                     max_disp=max_disp, fused_grad=True)
        else:
            onehot_m = one_hot(lab_m, n_class,
                               dtype=anatomy_dtype or torch.float32)
            anat = soft_dice_on_probs(warp_fn(onehot_m, deform), lab_f,
                                      n_class)
        loss = sim + reg_weight * reg + anatomy_weight * anat
        loss.backward()
        reg_state.optimizer.step()
        reg_state.step += 1
        metrics = {"loss": loss.detach(), "sim": sim.detach(),
                   "reg": reg.detach(), "anatomy": anat.detach()}
        if max_disp is not None:
            metrics["disp_overflow"] = displacement_overflow(deform.detach(),
                                                             max_disp)
        return reg_state, metrics

    return step


def _soft_dice(warped_m: torch.Tensor, f_probs: torch.Tensor) -> torch.Tensor:
    """Soft-soft dice over the foreground classes, float32 sums."""
    inter = (warped_m[..., 1:] * f_probs[..., 1:]).sum(
        dim=(1, 2, 3), dtype=torch.float32)
    denom = warped_m[..., 1:].sum(dim=(1, 2, 3), dtype=torch.float32) + \
        f_probs[..., 1:].sum(dim=(1, 2, 3), dtype=torch.float32)
    return 1.0 - torch.mean(2.0 * inter / (denom + 1e-5))


def make_joint_seg_step(supervised_loss: Callable, anatomy_weight: float,
                        supervised_weight: float, n_class: int,
                        warp_fn: Callable = grid_sample,
                        anatomy_dtype: Optional[torch.dtype] = None,
                        checkpoint_apply: bool = False,
                        two_pass: bool = True,
                        hard_fused: bool = False,
                        max_disp: Optional[int] = None):
    """Seg-phase step of joint training: updates the seg net against
    ``anatomy_weight * anatomy + supervised_weight * supervised``, the
    anatomy taken through the frozen reg net's deformation (computed under
    ``no_grad`` with ``train=False``), the supervised loss averaged over the
    sides that carry labels.

    ``two_pass`` takes the gradient as the sum of two sequenced backward
    passes, one through the moving branch (the fixed probabilities held
    constant), one through the fixed branch (the warped moving anatomy held
    constant); otherwise one graph holds both.  Either way the moving
    forward runs first, so BatchNorm's running statistics end as "moving,
    then fixed", as the reference composes them.

    ``hard_fused`` (two-pass only, needs ``max_disp``, the bound that
    ``warp_fn`` clamps to) takes, by the label flags, the cheapest branch
    that gives the same gradients, in the reference's table ``[soft, f_hard, m_hard, hard][all(m) * 2 + all(f)]``:

    * hard: both sides labelled; the anatomy reads constants only, so its
      value comes from ``kernels.hard_anatomy_dice`` (matched-label warp and
      a splat of ones) and the backward passes are supervised only;
    * m_hard: the moving one-hot is warped once, as a constant (no splat);
    * f_hard: the fixed one-hot is splatted once at the clamped field (the
      warp's adjoint, ``kernels.splat_trilinear``) and the anatomy is
      elementwise in the moving probabilities (no warp);
    * soft: the moving probabilities are warped and the warp's values
      gradient (the splat) runs in the backward.

    ``anatomy_dtype`` is the type of the one-hots and probabilities that are
    warped (float32 by default); the dice sums are float32.
    ``checkpoint_apply`` (recomputing each forward in the backward) is not
    ported: it would run BatchNorm in train mode twice and move the running
    statistics twice.

    Returns ``(seg_state, reg_state, moving, fixed, moving_seg, fixed_seg,
    moving_has_label, fixed_has_label) -> (seg_state, metrics)`` with the
    detached scalars ``loss``, ``anatomy`` and ``supervised``."""
    if checkpoint_apply:
        raise NotImplementedError(
            "checkpoint_apply is not ported: recomputing a train-mode "
            "forward in the backward would update BatchNorm's running "
            "statistics twice")
    if hard_fused and max_disp is None:
        raise ValueError("hard_fused requires max_disp (the matched-label "
                         "anatomy clamps the field first)")
    adt = anatomy_dtype or torch.float32

    def branch_probs(logits, has_label, onehot):
        probs = torch.softmax(logits.float(), dim=-1).to(adt)
        return torch.where(has_label[:, None, None, None, None], onehot,
                           probs)

    def step(seg_state: TrainState, reg_state: TrainState, moving, fixed,
             moving_seg, fixed_seg, moving_has_label, fixed_has_label):
        model = seg_state.model
        moving_seg, fixed_seg = moving_seg.long(), fixed_seg.long()
        with torch.no_grad():
            _, deform = reg_state.model.deformation(moving, fixed,
                                                    train=False)
        has_m = moving_has_label.to(moving.device)
        has_f = fixed_has_label.to(moving.device)
        any_m = float(bool(moving_has_label.any()))
        any_f = float(bool(fixed_has_label.any()))
        sup_norm = max(any_m + any_f, 1.0)

        def sup_term(logits, seg, any_side):
            sup = supervised_loss(logits.float(), seg)
            return sup, supervised_weight * sup * any_side / sup_norm

        def pass_b_supervised():
            logits_f = model(fixed, train=True)
            sup_f, loss = sup_term(logits_f, fixed_seg, any_f)
            loss.backward()
            return sup_f

        def pass_a_supervised():
            logits_m = model(moving, train=True)
            sup_m, loss = sup_term(logits_m, moving_seg, any_m)
            loss.backward()
            return sup_m

        def soft():
            logits_m = model(moving, train=True)
            logits_f = model(fixed, train=True)
            onehot_f = one_hot(fixed_seg, n_class, dtype=adt)
            # pass A: the moving branch against constant fixed probabilities
            f_probs_const = branch_probs(logits_f.detach(), has_f, onehot_f)
            m_probs = branch_probs(logits_m, has_m,
                                   one_hot(moving_seg, n_class, dtype=adt))
            warped_m = warp_fn(m_probs, deform)
            anat = _soft_dice(warped_m, f_probs_const)
            sup_m, sup_loss = sup_term(logits_m, moving_seg, any_m)
            (anatomy_weight * anat + sup_loss).backward()
            # pass B: the fixed branch against the constant warped anatomy
            warped_const = warped_m.detach()
            del logits_m, f_probs_const, m_probs, warped_m
            anat_b = _soft_dice(warped_const,
                                branch_probs(logits_f, has_f, onehot_f))
            sup_f, sup_loss = sup_term(logits_f, fixed_seg, any_f)
            (anatomy_weight * anat_b + sup_loss).backward()
            return anat, sup_m, sup_f

        def hard():
            with torch.no_grad():
                anat = hard_anatomy_dice(moving_seg, fixed_seg, deform,
                                         n_class, max_disp=max_disp)
            return anat, pass_a_supervised(), pass_b_supervised()

        def m_hard():
            with torch.no_grad():
                warped_const = warp_fn(
                    one_hot(moving_seg, n_class, dtype=adt), deform)
            sup_m = pass_a_supervised()
            logits_f = model(fixed, train=True)
            f_probs = branch_probs(logits_f, has_f,
                                   one_hot(fixed_seg, n_class, dtype=adt))
            anat = _soft_dice(warped_const, f_probs)
            sup_f, sup_loss = sup_term(logits_f, fixed_seg, any_f)
            (anatomy_weight * anat + sup_loss).backward()
            return anat, sup_m, sup_f

        def f_hard():
            # <warp(m_probs)_c, onehot_f_c> = <m_probs_c, splat(onehot_f)_c>:
            # one splat of a constant, the anatomy elementwise in m_probs
            with torch.no_grad():
                onehot_f = one_hot(fixed_seg, n_class, dtype=torch.float32)
                splat = splat_trilinear(
                    onehot_f, clamp_displacement(deform, max_disp).float()
                    .contiguous(), onehot_f.shape[1:4])
                w_all = splat.sum(dim=-1, keepdim=True)  # splat(ones)
                den_f = onehot_f[..., 1:].sum(dim=(1, 2, 3))
                del onehot_f
            logits_m = model(moving, train=True)
            m_probs = branch_probs(logits_m, has_m,
                                   one_hot(moving_seg, n_class, dtype=adt)
                                   ).float()
            inter = (m_probs[..., 1:] * splat[..., 1:]).sum(dim=(1, 2, 3))
            den_m = (m_probs[..., 1:] * w_all).sum(dim=(1, 2, 3))
            anat = 1.0 - torch.mean(2.0 * inter / (den_m + den_f + 1e-5))
            sup_m, sup_loss = sup_term(logits_m, moving_seg, any_m)
            (anatomy_weight * anat + sup_loss).backward()
            del logits_m, m_probs, splat, w_all
            return anat, sup_m, pass_b_supervised()

        def single_graph():
            logits_m = model(moving, train=True)
            logits_f = model(fixed, train=True)
            m_probs = branch_probs(logits_m, has_m,
                                   one_hot(moving_seg, n_class, dtype=adt))
            f_probs = branch_probs(logits_f, has_f,
                                   one_hot(fixed_seg, n_class, dtype=adt))
            anat = _soft_dice(warp_fn(m_probs, deform), f_probs)
            sup_m, loss_m = sup_term(logits_m, moving_seg, any_m)
            sup_f, loss_f = sup_term(logits_f, fixed_seg, any_f)
            (anatomy_weight * anat + loss_m + loss_f).backward()
            return anat, sup_m, sup_f

        seg_state.optimizer.zero_grad(set_to_none=True)
        if not two_pass:
            branch = single_graph
        elif hard_fused:
            index = int(bool(moving_has_label.all())) * 2 \
                + int(bool(fixed_has_label.all()))
            branch = (soft, f_hard, m_hard, hard)[index]
        else:
            branch = soft
        anat, sup_m, sup_f = branch()
        seg_state.optimizer.step()
        seg_state.step += 1
        sup = (sup_m.detach() * any_m + sup_f.detach() * any_f) / sup_norm
        loss = anatomy_weight * anat.detach() + supervised_weight * sup
        return seg_state, {"loss": loss, "anatomy": anat.detach(),
                           "supervised": sup}

    return step
