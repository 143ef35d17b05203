"""Spatial (depth-sharded) parallelism: one volume across a mesh axis.

Counterpart of ``deepatlas_tpu/parallel/spatial.py``: the D axis of each
volume splits over the ranks of the ``space`` axis, so whole volumes train
and serve past one card's memory.  Mechanics:

  * each k3 conv reads one neighbour plane on each side through
    ``ops.halo.halo_exchange_d`` and runs kernel A with depth padding 0
    (``models/layers.py``); its weight gradient is kernel D at depth
    padding 0, its input gradient goes back through the exchange's adjoint;
  * max-pool, the k2 s2 deconvs and the 1x1x1 head are shard-local;
  * BatchNorm moments and the dice loss's per-(batch, class) sums are
    summed over the axis (``collectives.psum``), LNCC and bending energy
    read halos and sum their masked terms, the registration warp is
    ``ops.halo.spatial_grid_sample`` (kernel E on a ``max_disp + 1``-plane
    halo): loss, gradients and BatchNorm statistics are the single-process
    values;
  * the per-rank gradients are averaged after the backward
    (``pmean_tree``): ``psum``'s backward sums the cotangents, so each rank
    holds ``n`` times its share and the mean is the single-process
    gradient, as in the JAX steps.

With a ``data_axis`` besides (DP x SP, the step level only) the batch
splits over it too: the dice loss takes a max and a sum over it, the
gradients are averaged over both axes, and the BatchNorm running
statistics, which each data replica moves with its own rows, are averaged
over the data axis as the DP step averages them.

Every rank runs the same step on its block of the batch
(``shard_volume_batch``); parameters start equal on every rank
(``dp.replicate``) and stay equal, since every rank applies the same
averaged gradients.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..metrics.confusion import confusion_matrix, dice_from_confusion
from ..models.layers import use_spatial_axis
from ..ops import one_hot
from ..ops.halo import shard_identity_grid, spatial_grid_sample
from ..train.steps import TrainState
from .collectives import (batchnorm_stats, param_grads, pmean_tree,
                          psum_many, psum_tree)
from .mesh import Mesh


def block_of(x, index: int, n: int, dim: int):
    """Block ``index`` of ``n`` equal blocks of ``x`` along ``dim`` (an
    array or a tensor), contiguous."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of size {size} does not split into "
                         f"{n} shards")
    k = size // n
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * k, (index + 1) * k)
    out = x[tuple(sl)]
    return out.contiguous() if isinstance(out, torch.Tensor) else out.copy()


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def shard_volume_batch(batch, mesh: Mesh, axis: str = "space",
                       data_axis: Optional[str] = None):
    """This rank's block of each ``(B, D, H, W[, C])`` array or tensor of
    ``batch``: its depth slab along ``axis`` and, with ``data_axis``, its
    rows along that one.  Every rank loads the whole batch and keeps its
    block, which is the JAX ``shard_volume_batch`` split."""
    sp, dp = mesh.axis(axis), mesh.axis(data_axis)

    def cut(x):
        if dp is not None and dp.size > 1:
            x = block_of(x, dp.index, dp.size, 0)
        return block_of(x, sp.index, sp.size, 1)

    return map_tree(cut, batch)


def make_spatial_seg_step(model: torch.nn.Module, criterion_factory: Callable,
                          n_class: int, mesh: Mesh, axis: str = "space",
                          data_axis: Optional[str] = None,
                          criterion_kwargs: Optional[dict] = None):
    """Seg train step on depth-sharded volumes.

    ``criterion_factory`` is ``get_loss_function("dice")``-style, taking
    ``axis_name`` / ``batch_axis_name``.  Returns ``step(state, images,
    labels) -> (state, loss, logits)`` on this rank's blocks
    (``shard_volume_batch``); ``state.model`` is ``model``.  Loss,
    gradients and BatchNorm statistics are those of
    ``steps.make_seg_train_step`` on the whole batch.
    """
    sp, dp = mesh.axis(axis), mesh.axis(data_axis)
    criterion = criterion_factory(n_class=n_class, axis_name=sp,
                                  batch_axis_name=dp,
                                  **dict(criterion_kwargs or {}))

    def step(state: TrainState, images, labels):
        state.optimizer.zero_grad(set_to_none=True)
        with use_spatial_axis(state.model, sp):
            logits = state.model(images, train=True)
        loss = criterion(logits.float(), labels)
        loss.backward()
        # one bucketed all-reduce for the gradients (none at one rank)
        pmean_tree(param_grads(state.model), (sp, dp))
        pmean_tree(batchnorm_stats(state.model), dp)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), logits.detach()

    return step


def make_spatial_reg_step(model: torch.nn.Module, sim_factory: Callable,
                          reg_factory: Callable, reg_weight: float,
                          mesh: Mesh, axis: str = "space",
                          data_axis: Optional[str] = None,
                          sim_kwargs: Optional[dict] = None,
                          reg_kwargs: Optional[dict] = None):
    """Registration train step on depth-sharded volume pairs: LNCC on the
    sharded warp's output and the bending energy of the displacement, each
    with its ``axis_name`` reductions, so loss and gradients equal
    ``reg_steps.make_reg_train_step`` with the warp clamped at the model's
    ``max_disp``.  With ``data_axis`` (DP x SP) the metrics are averaged
    over it and the gradients over both axes.  Returns ``step(state,
    moving, fixed) -> (state, metrics)``."""
    sp, dp = mesh.axis(axis), mesh.axis(data_axis)
    sim_loss = sim_factory(axis_name=sp, **(sim_kwargs or {}))
    reg_loss = reg_factory(axis_name=sp, **(reg_kwargs or {}))

    def step(state: TrainState, moving, fixed):
        state.optimizer.zero_grad(set_to_none=True)
        with use_spatial_axis(state.model, sp):
            disp, warped, _ = state.model(moving, fixed, train=True)
        sim = sim_loss(warped.float(), fixed.float())
        reg = reg_loss(disp.float())
        loss = sim + reg_weight * reg
        loss.backward()
        pmean_tree(param_grads(state.model), (sp, dp))
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach(), "sim": sim.detach(),
                   "reg": reg.detach()}
        pmean_tree(list(metrics.values()), dp)
        return state, metrics

    return step


def spatial_soft_dice(src_probs: torch.Tensor, tgt_probs: torch.Tensor,
                      axis, eps: float = 1e-5) -> torch.Tensor:
    """The joint anatomy soft dice (``reg_steps._soft_dice``) with its
    per-(batch, class) sums summed over the depth shards: foreground
    classes, float32 sums, the same value on every shard."""
    inter = (src_probs[..., 1:] * tgt_probs[..., 1:]).sum(
        dim=(1, 2, 3), dtype=torch.float32)
    den = src_probs[..., 1:].sum(dim=(1, 2, 3), dtype=torch.float32) + \
        tgt_probs[..., 1:].sum(dim=(1, 2, 3), dtype=torch.float32)
    inter, den = psum_many([inter, den], axis)
    return 1.0 - torch.mean(2.0 * inter / (den + eps))


def shard_overflow(deform: torch.Tensor, max_disp: int, axis) -> torch.Tensor:
    """``ops.displacement_overflow`` of a depth-sharded deformation: the
    identity is the global one sliced to the shard, and the fraction is
    averaged over the equal-size shards."""
    b, d_loc, h, w = deform.shape[:4]
    n = 1 if axis is None else axis.size
    disp = deform.float() - shard_identity_grid(deform.shape, axis,
                                                device=deform.device)
    scale = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0,
                          (d_loc * n - 1) / 2.0], dtype=torch.float32,
                         device=deform.device)
    over = ((disp.abs() * scale) > max_disp).any(dim=-1)
    return pmean_tree(over.float().mean(), axis)


def make_spatial_joint_steps(seg_model: torch.nn.Module,
                             reg_model: torch.nn.Module,
                             sim_factory: Callable, reg_factory: Callable,
                             supervised_factory: Callable, n_class: int,
                             reg_weight: float, anatomy_weight: float,
                             supervised_weight: float, mesh: Mesh,
                             axis: str = "space", max_disp: int = 8,
                             sim_kwargs: Optional[dict] = None,
                             reg_kwargs: Optional[dict] = None,
                             supervised_kwargs: Optional[dict] = None):
    """Depth-sharded joint DeepAtlas steps ``(joint_reg_step,
    joint_seg_step)``: ``reg_steps.make_joint_reg_step`` (dense anatomy) and
    ``make_joint_seg_step`` (one graph, the soft path) on a ``space`` axis,
    the warps on ``spatial_grid_sample`` clamped at ``max_disp``; the
    anatomy dice, LNCC, bending, supervised dice and BatchNorm sums reduce
    over the axis.  Signatures are the single-process steps', on this
    rank's depth slabs, with the ``(B,)`` label flags whole on every rank.
    """
    sp = mesh.axis(axis)
    sim_loss = sim_factory(axis_name=sp, **(sim_kwargs or {}))
    reg_loss = reg_factory(axis_name=sp, **(reg_kwargs or {}))
    supervised = supervised_factory(n_class=n_class, axis_name=sp,
                                    **(supervised_kwargs or {}))

    def labels(seg_state, images, gt, has):
        with torch.no_grad(), use_spatial_axis(seg_state.model, sp):
            pred = seg_state.model(images, train=False).argmax(dim=-1)
        return torch.where(has.to(pred.device)[:, None, None, None],
                           gt.long(), pred)

    def joint_reg_step(reg_state: TrainState, seg_state: TrainState, moving,
                       fixed, moving_seg, fixed_seg, moving_has_label,
                       fixed_has_label):
        lab_m = labels(seg_state, moving, moving_seg, moving_has_label)
        lab_f = labels(seg_state, fixed, fixed_seg, fixed_has_label)
        onehot_m = one_hot(lab_m, n_class, dtype=torch.float32)
        onehot_f = one_hot(lab_f, n_class, dtype=torch.float32)
        reg_state.optimizer.zero_grad(set_to_none=True)
        with use_spatial_axis(reg_state.model, sp):
            disp, warped, deform = reg_state.model(moving, fixed, train=True)
        sim = sim_loss(warped.float(), fixed.float())
        reg = reg_loss(disp.float())
        warped_m = spatial_grid_sample(onehot_m, deform, sp, max_disp)
        anat = spatial_soft_dice(warped_m, onehot_f, sp)
        loss = sim + reg_weight * reg + anatomy_weight * anat
        loss.backward()
        pmean_tree(param_grads(reg_state.model), sp)
        reg_state.optimizer.step()
        reg_state.step += 1
        return reg_state, {
            "loss": loss.detach(), "sim": sim.detach(), "reg": reg.detach(),
            "anatomy": anat.detach(),
            "disp_overflow": shard_overflow(deform.detach(), max_disp, sp)}

    def joint_seg_step(seg_state: TrainState, reg_state: TrainState, moving,
                       fixed, moving_seg, fixed_seg, moving_has_label,
                       fixed_has_label):
        with torch.no_grad(), use_spatial_axis(reg_state.model, sp):
            _, deform = reg_state.model.deformation(moving, fixed,
                                                    train=False)
        moving_seg, fixed_seg = moving_seg.long(), fixed_seg.long()
        onehot_m = one_hot(moving_seg, n_class, dtype=torch.float32)
        onehot_f = one_hot(fixed_seg, n_class, dtype=torch.float32)
        has_m = moving_has_label.to(moving.device)[:, None, None, None, None]
        has_f = fixed_has_label.to(moving.device)[:, None, None, None, None]
        any_m = float(bool(moving_has_label.any()))
        any_f = float(bool(fixed_has_label.any()))
        sup_norm = max(any_m + any_f, 1.0)
        seg_state.optimizer.zero_grad(set_to_none=True)
        with use_spatial_axis(seg_state.model, sp):
            logits_m = seg_state.model(moving, train=True)
            logits_f = seg_state.model(fixed, train=True)
        m_probs = torch.where(has_m, onehot_m,
                              torch.softmax(logits_m.float(), dim=-1))
        f_probs = torch.where(has_f, onehot_f,
                              torch.softmax(logits_f.float(), dim=-1))
        warped_m = spatial_grid_sample(m_probs, deform, sp, max_disp)
        anat = spatial_soft_dice(warped_m, f_probs, sp)
        sup_m = supervised(logits_m.float(), moving_seg)
        sup_f = supervised(logits_f.float(), fixed_seg)
        sup = (sup_m * any_m + sup_f * any_f) / sup_norm
        loss = anatomy_weight * anat + supervised_weight * sup
        loss.backward()
        pmean_tree(param_grads(seg_state.model), sp)
        seg_state.optimizer.step()
        seg_state.step += 1
        return seg_state, {"loss": loss.detach(), "anatomy": anat.detach(),
                           "supervised": sup.detach()}

    return joint_reg_step, joint_seg_step


def make_spatial_seg_eval_step(model: torch.nn.Module, n_class: int,
                               mesh: Mesh, axis: str = "space"):
    """Depth-sharded eval: ``(state, images, labels) -> (per_class_dice
    (B, n_class - 1), logits)``, the dice from per-volume confusion counts
    summed over the shards (``steps.make_seg_eval_step``'s values); the
    logits are this rank's slab."""
    sp = mesh.axis(axis)

    def eval_step(state: TrainState, images, labels):
        with torch.no_grad(), use_spatial_axis(state.model, sp):
            logits = state.model(images, train=False)
            preds = logits.argmax(dim=-1)
            cms = torch.stack([confusion_matrix(p, t, n_class)
                               for p, t in zip(preds, labels.long())])
            psum_tree(cms, sp)
            dice = torch.stack([dice_from_confusion(cm, 1e-11)[1:]
                                for cm in cms])
        return dice, logits

    return eval_step


def make_spatial_seg_forward(model: torch.nn.Module, mesh: Mesh,
                             axis: str = "space"):
    """Depth-sharded inference forward: ``(state, images) -> logits``,
    this rank's slab of the whole-volume logits (eval-mode BatchNorm); with
    the batch split over replicas besides, each rank's rows."""
    sp = mesh.axis(axis)

    def forward(state: TrainState, images):
        with torch.no_grad(), use_spatial_axis(state.model, sp):
            return state.model(images, train=False)

    return forward
