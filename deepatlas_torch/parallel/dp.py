"""Data-parallel train and eval steps over a mesh's ``data`` axis.

Counterpart of ``deepatlas_tpu/parallel/dp.py``: each rank runs the
single-process step's forward and backward on its rows of the batch, then
one bucketed all-reduce per dtype averages the loss, the gradients and the
BatchNorm running statistics (each replica moves them with its own batch
moments, as the JAX step's ``pmean`` of the new statistics does: neither
``SyncBatchNorm`` nor DDP, which leaves buffers alone), and every rank
applies the same update.  At one rank the reduction is skipped.

Every rank loads the same batch (the same loader and seed) and keeps its
rows (``shard_batch``); ``replicate`` broadcasts rank 0's parameters and
buffers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..metrics import multiclass_dice
from ..metrics.confusion import confusion_matrix, dice_from_confusion
from ..train.reg_steps import make_joint_reg_step, make_joint_seg_step
from ..train.steps import TrainState
from .collectives import (all_gather, batchnorm_stats, broadcast_,
                          param_grads, pmean_tree, psum_tree)
from .mesh import Mesh
from .spatial import block_of, map_tree


def shard_batch(batch, mesh: Mesh, axis_name: str = "data"):
    """This rank's rows (leading axis) of each array or tensor of
    ``batch``; the batch must split evenly."""
    ax = mesh.axis(axis_name)
    return map_tree(lambda x: block_of(x, ax.index, ax.size, 0), batch)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Overwrite ``module``'s parameters and buffers on every rank with
    rank 0's (a broadcast over each axis), in place; returns it."""
    broadcast_(list(module.parameters()) + list(module.buffers()),
               [mesh.axis(name) for name in mesh.axes])
    return module


def make_dp_seg_train_step(criterion: Callable, mesh: Mesh,
                           axis_name: str = "data"):
    """``(state, images, labels) -> (state, loss, logits)`` on this rank's
    rows: the loss and gradients are the means over the replicas, so the
    update is the single-process step's on the whole batch up to the
    BatchNorm moments, which are each replica's own."""
    ax = mesh.axis(axis_name)

    def train_step(state: TrainState, images, labels):
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(images, train=True)
        loss = criterion(logits.float(), labels)
        loss.backward()
        loss = loss.detach()
        # one bucketed all-reduce for loss, gradients and BN statistics
        pmean_tree([loss] + param_grads(state.model)
                   + batchnorm_stats(state.model), ax)
        state.optimizer.step()
        state.step += 1
        return state, loss, logits.detach()

    return train_step


def make_dp_seg_eval_step(n_class: int, mesh: Mesh,
                          axis_name: str = "data"):
    """``(state, images, labels) -> (dice (B, n_class - 1), logits)``: each
    replica's per-volume foreground dice, gathered in rank order into the
    whole batch's; the logits are this rank's rows."""
    ax = mesh.axis(axis_name)

    def eval_step(state: TrainState, images, labels):
        with torch.no_grad():
            logits = state.model(images, train=False)
            dice = multiclass_dice(logits.argmax(dim=-1), labels.long(),
                                   n_class)
        return all_gather(dice, ax), logits

    return eval_step


def make_dp_confusion_eval_step(n_class: int, mesh: Mesh,
                                axis_name: str = "data"):
    """``(state, images, labels) -> dice (n_class - 1,)`` from one
    confusion matrix summed over the replicas (micro-averaged)."""
    ax = mesh.axis(axis_name)

    def eval_step(state: TrainState, images, labels):
        with torch.no_grad():
            logits = state.model(images, train=False)
            cm = confusion_matrix(logits.argmax(dim=-1), labels.long(),
                                  n_class)
            psum_tree(cm, ax)
        return dice_from_confusion(cm, 1e-11)[1:]

    return eval_step


def make_dp_reg_train_step(sim_loss: Callable, reg_loss: Callable,
                           reg_weight: float, mesh: Mesh,
                           axis_name: str = "data",
                           max_disp: Optional[int] = None):
    """Data-parallel registration step ``(state, moving, fixed) -> (state,
    metrics)``: ``reg_steps.make_reg_train_step`` on this rank's rows, the
    metrics and gradients averaged over the replicas in one all-reduce."""
    from ..ops import displacement_overflow
    ax = mesh.axis(axis_name)

    def train_step(state: TrainState, moving, fixed):
        state.optimizer.zero_grad(set_to_none=True)
        disp, warped, deform = state.model(moving, fixed, train=True)
        sim = sim_loss(warped.float(), fixed.float())
        reg = reg_loss(disp.float())
        loss = sim + reg_weight * reg
        loss.backward()
        metrics = {"loss": loss.detach(), "sim": sim.detach(),
                   "reg": reg.detach()}
        if max_disp is not None:
            metrics["disp_overflow"] = displacement_overflow(
                deform.detach(), max_disp)
        pmean_tree(list(metrics.values()) + param_grads(state.model), ax)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def make_dp_joint_steps(sim_loss: Callable, reg_loss: Callable,
                        sup_loss: Callable, reg_weight: float,
                        anatomy_weight: float, supervised_weight: float,
                        n_class: int, mesh: Mesh, axis_name: str = "data",
                        **kwargs):
    """Data-parallel joint DeepAtlas steps ``(dp_reg_step, dp_seg_step)``:
    ``reg_steps.make_joint_reg_step`` / ``make_joint_seg_step`` on this
    rank's rows with ``data_axis`` set.  Each rank resolves its own rows'
    label regime (no branch holds a collective); the supervised weight of
    a side is ``labelled * n_replicas / max(labelled branches over the
    replicas, 1)``, so the averaged gradient is the single-process step's
    labelled mean; gradients, BatchNorm statistics and metrics are averaged
    in one all-reduce before the update.  ``kwargs`` go to both factories
    where they take them (``warp_fn``, ``anatomy_dtype``, ``max_disp``,
    ``fused_anatomy`` for the reg step; ``two_pass``, ``hard_fused`` for the
    seg step)."""
    ax = mesh.axis(axis_name)
    reg_kw = {k: kwargs[k] for k in ("warp_fn", "anatomy_dtype", "max_disp",
                                     "fused_anatomy") if k in kwargs}
    seg_kw = {k: kwargs[k] for k in ("warp_fn", "anatomy_dtype", "two_pass",
                                     "hard_fused", "max_disp")
              if k in kwargs}
    if "seg_warp_fn" in kwargs:
        seg_kw["warp_fn"] = kwargs["seg_warp_fn"]
    reg_step = make_joint_reg_step(sim_loss, reg_loss, reg_weight,
                                   anatomy_weight, n_class, data_axis=ax,
                                   **reg_kw)
    seg_step = make_joint_seg_step(sup_loss, anatomy_weight,
                                   supervised_weight, n_class, data_axis=ax,
                                   **seg_kw)
    return reg_step, seg_step
