"""The passes each step kind makes, counted from the configuration's layer
shapes, and the kernel calls and model operations they take.

Counted this way, a later change that fuses or replaces a kernel leaves the
work the same and moves only the time.  A step kind's calls:

* ``seg``: one UNet_light training pass on the batch,
  ``deepatlas_torch/train/steps.py:54`` (forward) and ``:56`` (backward);
* ``serve``: one volume's tiles, in tile batches padded to whole batches,
  through the UNet_light forward, ``deepatlas_torch/train/inference.py:42``;
* ``joint_seg.<regime>``: the frozen VoxelMorph forward,
  ``deepatlas_torch/train/reg_steps.py:247``, and two UNet_light training
  passes, moving then fixed (``:281``-``:282`` soft, ``:275``/``:269``
  hard, ``:275``/``:312`` m_hard, ``:331``/``:269`` f_hard), with the
  regime's anatomy warps (``:288``, ``:303``, ``:325``);
* ``joint_reg.<n>``: ``n`` UNet_light eval forwards of the unlabelled sides,
  ``reg_steps.py:106``, and one VoxelMorph training pass, ``:144`` and
  ``:156``, with the matched-label anatomy's splat of ones, ``:148``.

A training pass is the forward, the input gradient of every layer but the
first (whose input is an image) and the weight gradient of every layer.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

from .work import bound_s, warp_bytes, work

DTYPE = "bfloat16"


@dataclass(frozen=True)
class Call:
    """One piece of work: the port kernel that runs it (``matmul`` for the
    torch matrix products), its operations and bytes, and whether its
    operations are model math (counted in MFU)."""
    kernel: str
    flops: float
    nbytes: float
    model: bool = True

    def bound_s(self) -> float:
        return bound_s(self.flops, self.nbytes, DTYPE)


@dataclass(frozen=True)
class Layer:
    kind: str           # k3, deconv, point, up2x
    n_in: int
    n_out: int
    cin: int
    cout: int
    stride: int = 1


def _vox(shape, batch=1) -> int:
    return int(batch * math.prod(shape))


def _half(shape):
    return tuple(-(-n // 2) for n in shape)


def cropped_shape(config) -> tuple:
    shape, c = config["volume_shape"], config.get("crop_size") or [0] * 6
    return tuple(shape[i] - c[i] - c[i + 3] for i in range(3))


def unet_layers(config, shape, batch=1) -> List[Layer]:
    """UNet_light's layers (``deepatlas_torch/models/unet.py``): each
    encoder level's k3 convs, a 2x max-pool between levels, each decoder
    level's k2 s2 deconv, the skip concat and its k3 convs, the 1x1x1
    head."""
    enc, dec = config["encoders"], config["decoders"]
    sizes = [tuple(shape)]
    for _ in range(len(enc) - 1):
        sizes.append(tuple(n // 2 for n in sizes[-1]))
    layers, cin, skips = [], config["in_channel"], []
    for i, plan in enumerate(enc):
        n = _vox(sizes[i], batch)
        for f in (plan if i == 0 else plan[1:]):
            layers.append(Layer("k3", n, n, cin, f))
            cin = f
        skips.append(cin)
    for j, plan in enumerate(dec):
        lvl = len(enc) - 2 - j
        n_lo, n_hi = _vox(sizes[lvl + 1], batch), _vox(sizes[lvl], batch)
        layers.append(Layer("deconv", n_lo, n_hi, cin, plan[0]))
        cin = plan[0] + skips[lvl]
        for f in plan[1:]:
            layers.append(Layer("k3", n_hi, n_hi, cin, f))
            cin = f
    n0 = _vox(sizes[0], batch)
    layers.append(Layer("point", n0, n0, cin, config["n_classes"]))
    return layers


def voxelmorph_layers(config, shape, batch=1) -> List[Layer]:
    """VoxelMorph-CVPR2018's layers (``deepatlas_torch/models/
    voxelmorph.py``): a stride-1 and four stride-2 k3 encoder convs over the
    2-channel pair, decoder convs at the encoders' sizes after nearest
    upsamples, the full-resolution upsample (a deconv with the identity
    bank) and the 3-channel flow head over the concat with the first
    encoder."""
    e, d = config["reg_enc"], config["reg_dec"]
    sizes = [tuple(shape)]
    for _ in range(4):
        sizes.append(_half(sizes[-1]))
    n = [_vox(s, batch) for s in sizes]
    layers = [Layer("k3", n[0], n[0], 2, e[0])]
    for i in range(1, 5):
        layers.append(Layer("k3", n[i - 1], n[i], e[i - 1], e[i], stride=2))
    dec_in = (e[4], d[0] + e[3], d[1] + e[2], d[2] + e[1])
    at = (n[3], n[2], n[1], n[1])
    for ci, f, nv in zip(dec_in, d[:4], at):
        layers.append(Layer("k3", nv, nv, ci, f))
    layers.append(Layer("up2x", n[1], n[0], d[3], d[3]))
    layers.append(Layer("k3", n[0], n[0], d[3], d[4]))
    layers.append(Layer("k3", n[0], n[0], d[4] + e[0], 3))
    return layers


def forward_calls(layers: Sequence[Layer]) -> List[Call]:
    calls = []
    for ly in layers:
        if ly.kind == "k3":
            calls.append(Call("conv3d_k3", *work(
                "conv3d_k3", ly.n_in, ly.cin, ly.cout, DTYPE, ly.n_out)))
        elif ly.kind == "point":
            calls.append(Call("conv3d_point", *work(
                "conv3d_point", ly.n_in, ly.cin, ly.cout, DTYPE)))
        else:   # deconv and the identity-bank upsample run kernel C
            calls.append(Call("deconv2x", *work(
                "deconv2x", ly.n_in, ly.cin, ly.cout, DTYPE),
                model=ly.kind == "deconv"))
    return calls


def backward_calls(layers: Sequence[Layer]) -> List[Call]:
    """Input gradients of every layer but the first, weight gradients of
    every layer with weights."""
    calls = []
    for i, ly in enumerate(layers):
        dx = i > 0
        if ly.kind == "k3":
            if dx and ly.stride == 2:
                calls.append(Call("conv3d_k3", *work(
                    "conv3d_k3", ly.n_in, ly.cout, ly.cin, DTYPE, ly.n_out,
                    role="dx_s2")))
            elif dx:
                calls.append(Call("conv3d_k3", *work(
                    "conv3d_k3", ly.n_out, ly.cout, ly.cin, DTYPE)))
            calls.append(Call("conv3d_k3_wgrad", *work(
                "conv3d_k3_wgrad", ly.n_in, ly.cin, ly.cout, DTYPE,
                ly.n_out)))
        elif ly.kind == "point":
            if dx:
                calls.append(Call("conv3d_point", *work(
                    "conv3d_point", ly.n_in, ly.cout, ly.cin, DTYPE)))
            calls.append(Call("matmul", 2.0 * ly.n_in * ly.cin * ly.cout,
                              0.0))
        elif ly.kind == "deconv":
            f = 2.0 * 8 * ly.n_in * ly.cin * ly.cout
            if dx:
                calls.append(Call("matmul", f, 0.0))
            calls.append(Call("matmul", f, 0.0))
        else:   # up2x: a constant bank, its input gradient only, no math
            calls.append(Call("matmul", 2.0 * 8 * ly.n_in * ly.cin * ly.cout,
                              0.0, model=False))
    return calls


def train_calls(layers) -> List[Call]:
    return forward_calls(layers) + backward_calls(layers)


def _splat(n, c, elem) -> Call:
    return Call("splat_trilinear", 0.0,
                warp_bytes("splat_trilinear", n, c, elem), model=False)


def _splat_ones(n) -> Call:
    return Call("splat_trilinear", 0.0, warp_bytes("splat_ones", n, 1, 4),
                model=False)


def serve_tiles(config) -> int:
    """Tiles of one volume under the configuration's ``Partition``, padded
    to whole tile batches."""
    e = [t - 2 * o for t, o in zip(config["tile"], config["overlap"])]
    n = math.prod(-(-s // k) for s, k in zip(config["volume_shape"], e))
    b = config["tile_batch"]
    return -(-n // b) * b


def step_calls(config, kind: str, batch: int = 1) -> List[Call]:
    """The calls of one unit of work of ``kind`` (module docstring)."""
    if kind == "serve":
        tiles = serve_tiles(config)
        return forward_calls(unet_layers(config, config["tile"], tiles))
    shape = cropped_shape(config)
    n = _vox(shape, batch)
    unet = unet_layers(config, shape, batch)
    if kind == "seg":
        return train_calls(unet)
    vm = voxelmorph_layers(config, shape, batch)
    c = config["n_classes"]
    if kind.startswith("joint_seg."):
        regime = kind.split(".", 1)[1]
        anatomy = {"soft": [_splat(n, c, 2)], "f_hard": [_splat(n, c, 4)],
                   "m_hard": [], "hard": [_splat_ones(n)]}[regime]
        return forward_calls(vm) + 2 * train_calls(unet) + anatomy
    if kind.startswith("joint_reg."):
        subs = int(kind.split(".", 1)[1])
        return subs * forward_calls(unet) + train_calls(vm) \
            + [_splat_ones(n)]
    raise ValueError(f"unknown step kind {kind!r}")


def model_flops(config, kind: str, batch: int = 1) -> float:
    return sum(c.flops for c in step_calls(config, kind, batch) if c.model)


def kernel_bound_s(config, kind: str, kernels: Sequence[str],
                   batch: int = 1) -> float:
    """Least seconds of the calls of ``kind`` that run on ``kernels``."""
    return sum(c.bound_s() for c in step_calls(config, kind, batch)
               if c.kernel in kernels)
