"""Plain PyTorch forwards of UNet_light and VoxelMorph-CVPR2018.

Channels-first ``(B, C, D, H, W)`` tensors on ``torch.nn.functional``
convolutions, in float32 (``precision.Precision`` rounds what each
convolution reads for the control).  Parameters are a dict of tensors under
the names and in the layouts of the published networks' parameter trees:
k3 kernels ``(3, 3, 3, Cin, Cout)``, k2 transposed kernels ``(2, 2, 2,
Cin, Cout)``, the 1x1x1 head ``(Cin, Cout)``.  BatchNorm (eps 1e-5,
momentum 0.9) normalizes with the biased batch variance in training and
moves its running statistics by ``0.9 r + 0.1 batch``; LeakyReLU's slope is
0.01.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

Params = Dict[str, torch.Tensor]
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


# ------------------------------------------------------------ parameter specs
def unet_spec(config) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every UNet_light parameter and statistic;
    kinds: ``w`` a kernel, ``b`` a bias, ``g`` a BatchNorm scale, ``m`` /
    ``v`` running mean / variance."""
    enc, dec = config["encoders"], config["decoders"]
    out, cin, skips = [], config["in_channel"], []

    def block(name, k, ci, co):
        out.append((f"{name}.weight", (k, k, k, ci, co), "w"))
        out.append((f"{name}.bias", (co,), "b"))
        out.append((f"{name}.bn.weight", (co,), "g"))
        out.append((f"{name}.bn.bias", (co,), "b"))
        out.append((f"{name}.bn.running_mean", (co,), "m"))
        out.append((f"{name}.bn.running_var", (co,), "v"))

    for i, plan in enumerate(enc):
        for j, f in enumerate(plan if i == 0 else plan[1:]):
            block(f"enc.{i}.{j}", 3, cin, f)
            cin = f
        skips.append(cin)
    for j, plan in enumerate(dec):
        block(f"ups.{j}", 2, cin, plan[0])
        cin = plan[0] + skips[len(enc) - 2 - j]
        for k, f in enumerate(plan[1:]):
            block(f"dec.{j}.{k}", 3, cin, f)
            cin = f
    out.append(("head.weight", (cin, config["n_classes"]), "w"))
    out.append(("head.bias", (config["n_classes"],), "b"))
    return out


def voxelmorph_spec(config) -> List[Tuple[str, tuple, str]]:
    e, d = config["reg_enc"], config["reg_dec"]
    out, cin = [], 2
    for i, f in enumerate(e):
        out += [(f"enc.{i}.weight", (3, 3, 3, cin, f), "w"),
                (f"enc.{i}.bias", (f,), "b")]
        cin = f
    dec_in = (e[4], d[0] + e[3], d[1] + e[2], d[2] + e[1], d[3])
    for i, (ci, f) in enumerate(zip(dec_in, d)):
        out += [(f"dec.{i}.weight", (3, 3, 3, ci, f), "w"),
                (f"dec.{i}.bias", (f,), "b")]
    out += [("head.weight", (3, 3, 3, d[4] + e[0], 3), "flow"),
            ("head.bias", (3,), "b")]
    return out


# ------------------------------------------------------------------- layers
def _k3(p: Params, name: str, x, prec: Precision, stride=1):
    w = p[f"{name}.weight"].permute(4, 3, 0, 1, 2)
    return prec(F.conv3d(prec(x), prec(w), p[f"{name}.bias"], stride=stride,
                         padding=1))


def _bn(p: Params, stats: Params, name: str, y, train: bool):
    g, b = p[f"{name}.bn.weight"], p[f"{name}.bn.bias"]
    if train:
        mean = y.mean(dim=(0, 2, 3, 4))
        var = ((y - mean[None, :, None, None, None]) ** 2).mean(
            dim=(0, 2, 3, 4))
        if stats is not None:
            with torch.no_grad():
                rm, rv = (f"{name}.bn.running_mean", f"{name}.bn.running_var")
                stats[rm] = BN_MOMENTUM * stats[rm] + (1 - BN_MOMENTUM) * mean
                stats[rv] = BN_MOMENTUM * stats[rv] + (1 - BN_MOMENTUM) * var
    else:
        mean = stats[f"{name}.bn.running_mean"]
        var = stats[f"{name}.bn.running_var"]
    mul = g * torch.rsqrt(var + BN_EPS)
    add = b - mean * mul
    return y * mul[None, :, None, None, None] + add[None, :, None, None, None]


def unet_forward(config, p: Params, stats: Params, x, train: bool,
                 prec: Precision) -> torch.Tensor:
    """UNet_light logits ``(B, n_classes, D, H, W)`` of ``x`` ``(B, 1, D,
    H, W)``.  ``stats`` holds the running statistics; a training forward
    moves them (pass None to leave them)."""
    enc, dec = config["encoders"], config["decoders"]

    def block(name, h, conv):
        y = conv(h)
        return F.leaky_relu(_bn(p, stats, name, y, train), 0.01)

    h, skips = x, []
    for i, plan in enumerate(enc):
        for j in range(len(plan if i == 0 else plan[1:])):
            h = block(f"enc.{i}.{j}", h,
                      lambda t, n=f"enc.{i}.{j}": _k3(p, n, t, prec))
        if i < len(enc) - 1:
            skips.append(h)
            h = F.max_pool3d(h, 2)
    for j, plan in enumerate(dec):
        name = f"ups.{j}"
        w = p[f"{name}.weight"].permute(3, 4, 0, 1, 2)
        h = block(name, h, lambda t, w=w, n=name: prec(F.conv_transpose3d(
            prec(t), prec(w), p[f"{n}.bias"], stride=2)))
        h = torch.cat([h, skips.pop()], dim=1)
        for k in range(len(plan) - 1):
            h = block(f"dec.{j}.{k}", h,
                      lambda t, n=f"dec.{j}.{k}": _k3(p, n, t, prec))
    w = p["head.weight"].t()[:, :, None, None, None]
    return prec(F.conv3d(prec(h), prec(w), p["head.bias"]))


def _nearest(x, size):
    return F.interpolate(x, size=tuple(size), mode="nearest")


def voxelmorph_disp(p: Params, source, target, prec: Precision
                    ) -> torch.Tensor:
    """The displacement field ``(B, D, H, W, 3)``, last axis ``(x, y, z)`` in
    normalized units, of ``source`` onto ``target`` ``(B, 1, D, H, W)``."""
    x = torch.cat([source, target], dim=1)
    encs = []
    for i in range(5):
        x = F.relu(_k3(p, f"enc.{i}", x, prec, stride=1 if i == 0 else 2))
        encs.append(x)
    e1, e2, e3, e4, e5 = encs

    def conv(i, h):
        return F.relu(_k3(p, f"dec.{i}", h, prec))

    d1 = conv(0, _nearest(e5, e4.shape[2:]))
    d2 = conv(1, _nearest(torch.cat([d1, e4], 1), e3.shape[2:]))
    d3 = conv(2, _nearest(torch.cat([d2, e3], 1), e2.shape[2:]))
    d4 = conv(3, torch.cat([d3, e2], 1))
    d5 = conv(4, _nearest(d4, e1.shape[2:]))
    flow = _k3(p, "head", torch.cat([d5, e1], 1), prec)
    return flow.permute(0, 2, 3, 4, 1)
