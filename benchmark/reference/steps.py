"""Plain training steps of the DeepAtlas recipes, with a hand-written Adam.

Each step takes the parameters as float32 leaves that require gradients,
runs the forward and backward of its loss, moves the parameters by Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the root) and returns the loss it
reports.  The joint steps follow the semi-supervised scheme of DeepAtlas
(arXiv:1904.08465): the seg step trains the segmentation net on the
supervised dice of the labelled sides and the anatomy dice through the
frozen registration net's warp; the reg step trains the registration net on
LNCC, bending energy and the anatomy dice, with the frozen segmentation
net's argmax in place of missing labels.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import nets, ops
from .precision import Precision


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            params, lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.first_grads = None

    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        grads = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads[k] = g.clone()
                self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = (self.v[k] / c2).sqrt() + self.eps
                p.sub_(self.lr * (self.m[k] / c1) / denom)
                p.grad = None
        if self.first_grads is None:
            self.first_grads = grads


class Net:
    """One network's trainable leaves, running statistics and optimizer."""

    def __init__(self, weights: Dict[str, torch.Tensor], kinds, lr: float):
        stat = {k for k, _, kind in kinds if kind in ("m", "v")}
        self.params = {k: weights[k].detach().float().clone()
                       .requires_grad_(True)
                       for k, _, _ in kinds if k not in stat}
        self.stats = {k: weights[k].detach().float().clone() for k in stat}
        self.opt = Adam(self.params, lr)


def seg_step(config, net: Net, image, labels, prec: Precision) -> float:
    """``train_seg.py``'s step: dice loss on the logits, backward, Adam."""
    logits = nets.unet_forward(config, net.params, net.stats, image, True,
                               prec)
    loss = ops.dice_loss(logits, labels, config["n_classes"])
    loss.backward()
    net.opt.step()
    return float(loss.detach())


def _branch(logits, has_label: bool, onehot):
    return onehot if has_label else torch.softmax(logits, dim=1)


def joint_seg_step(config, seg: Net, reg: Net, moving, fixed, seg_m, seg_f,
                   has_m: bool, has_f: bool, prec: Precision) -> float:
    """The seg phase: ``anatomy_weight * anatomy + supervised_weight *
    supervised``, the supervised dice averaged over the labelled sides, the
    anatomy between the warped moving and the fixed probabilities (one-hots
    where labelled).  Every label regime takes this one formula."""
    c = config["n_classes"]
    aw, sw = config["anatomy_weight"], config["supervised_weight"]
    with torch.no_grad():
        disp = nets.voxelmorph_disp(reg.params, moving, fixed, prec)
        grid = ops.clamped_deformation(disp, config["max_disp"])
    logits_m = nets.unet_forward(config, seg.params, seg.stats, moving, True,
                                 prec)
    logits_f = nets.unet_forward(config, seg.params, seg.stats, fixed, True,
                                 prec)
    m_probs = _branch(logits_m, has_m, ops.one_hot(seg_m, c))
    f_probs = _branch(logits_f, has_f, ops.one_hot(seg_f, c))
    anat = ops.soft_dice(ops.warp(m_probs, grid), f_probs)
    norm = max(float(has_m) + float(has_f), 1.0)
    sup = (ops.dice_loss(logits_m, seg_m, c) * float(has_m)
           + ops.dice_loss(logits_f, seg_f, c) * float(has_f)) / norm
    loss = aw * anat + sw * sup
    loss.backward()
    seg.opt.step()
    return float(loss.detach())


def joint_reg_step(config, reg: Net, seg: Net, moving, fixed, seg_m, seg_f,
                   has_m: bool, has_f: bool, prec: Precision) -> float:
    """The reg phase: ``lncc + reg_weight * bending + anatomy_weight *
    anatomy``, the anatomy the soft dice of the warped moving one-hot
    against the fixed labels, the frozen seg net's argmax for a side
    without labels."""
    c = config["n_classes"]

    def labels(image, gt, has):
        if has:
            return gt
        with torch.no_grad():
            return nets.unet_forward(config, seg.params, seg.stats, image,
                                     False, prec).argmax(dim=1)

    lab_m, lab_f = labels(moving, seg_m, has_m), labels(fixed, seg_f, has_f)
    disp = nets.voxelmorph_disp(reg.params, moving, fixed, prec)
    grid = ops.clamped_deformation(disp, config["max_disp"])
    sim = ops.lncc_loss(ops.warp(moving, grid), fixed,
                        config["lncc_window"])
    bend = ops.bending_energy(disp)
    anat = ops.soft_dice(ops.warp(ops.one_hot(lab_m, c), grid),
                         ops.one_hot(lab_f, c))
    loss = sim + config["reg_weight"] * bend \
        + config["anatomy_weight"] * anat
    loss.backward()
    reg.opt.step()
    return float(loss.detach())


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Dict[str, float]:
    """Per leaf (those in ``keep``): ``|got - ref|`` of its norm over the
    larger of that leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return {}
    med = sorted(ref[k] for k in names)[len(names) // 2]
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}
