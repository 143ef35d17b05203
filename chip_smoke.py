#!/usr/bin/env python3
"""Smoke run of deepatlas_torch on one CUDA card: the quickest proof that
the PyTorch port builds, is right and runs its main path on the GPU.

Phases (one JSON line each, any failure exits nonzero before the last line):

  1. device  -- card name, ``nvidia-smi`` name and power limit; TF32 off for
     every float32 reference.
  2. build   -- compile the CUDA sources of deepatlas_torch/kernels/csrc.
  3. kernels -- each kernel against its plain PyTorch version at every
     shape the three main paths launch it at, in float32 and bfloat16, with
     kernel / plain / library (cuDNN) times from CUDA events and the least
     time the card could take (``bound_ms``).  Serving: the UNet_light tile
     forward (batch 4 of 128^3 tiles).  Training: one step on a 168x200x168
     volume with 32 classes -- the forward convs, kernel A again at its 13
     input-gradient shapes (Cin and Cout swapped), the head's kernel at its
     input-gradient shape, and the k3 weight-gradient kernel at its 14
     shapes.  Registration: one VoxelMorph step on a 168x200x168 pair --
     kernel A at its 11 forward (4 of them strided) and 10 input-gradient
     shapes and the weight-gradient kernel at its 11 (4 strided), the
     transposed-conv kernel at the decoder's full-resolution upsample (also
     with the identity bank against ``nearest_resize``), and the three warp
     kernels (trilinear warp, its grid
     gradient, the splat) at 1x168x200x168 with one float32 channel (the
     step's call) and two bfloat16 channels, on a smooth field (up to 2.5
     voxels) and on a saturated one (up to 20 voxels, clamped to 8), and at
     one odd small shape; then the differentiable entry point's two
     gradients against the same Function on the plain versions.
  4. main    -- the segmentation serving path: a synthetic OAI-ZIB corpus
     (160x384x384 volumes, labels 0..4, from ``--seed``), UNet_light with
     seeded weights and BatchNorm statistics saved as a checkpoint, and
     ``infer_seg_torch.main`` at the documented OAI setting (tile 128^3,
     overlap 16, tile batch 4, bf16).  The launch counters must show 14 k3
     convs, 3 deconvs and 1 head per tile batch, the CLI's Dice lines must
     be finite, and one tile batch through the kernels must agree with the
     same net on the plain versions.
  5. train   -- the segmentation training path: a synthetic MindBoggle-layout
     corpus (182x218x182 volumes, 32 labels whose intensity follows the
     label, from ``--seed``) and ``train_seg_torch.main --num-samples 21
     --num-epochs 1``: 42 training steps at the recipe's full width
     (UNet_light, 32 classes, bf16, crop to 168x200x168, dice, Adam), one
     validation, a checkpoint, and ``test()``.  The launch counters must show
     27 k3 convs (14 forward + 13 input gradients), 14 weight gradients, 3
     deconvs and 2 head convs per training step plus 14 / 3 / 1 per
     evaluated volume; every loss must be finite and the last 10 steps' mean
     below the first 10's; the test dice must be finite; and one step's
     gradients through the kernels must agree with the same step on the
     plain versions.

  6. reg     -- the registration training path: a synthetic MindBoggle-layout
     corpus whose volumes are smooth deformations (a few voxels) of one
     textured, labelled base, and ``train_reg_torch.main --num-samples 21
     --num-epochs 1 --max-validation-pairs 2``: 42 steps at the recipe's
     full width (VoxelMorph-CVPR2018 in bf16 with a float32 flow and warp
     clamped to 8 voxels, crop to 168x200x168, LNCC-9 + bending energy,
     Adam), one validation (warped-label dice, folding fraction), a
     checkpoint and ``test()``.  Per training step the counters must show 21
     k3 convs (11 forward + 10 input gradients), 11 weight gradients, 1
     transposed conv (the decoder's upsample to full resolution, identity
     bank), 1 warp and 1 grid gradient and no splat (the moving image is
     data), per evaluated pair 11 k3 convs, 1 transposed conv and 1 warp;
     every loss must be finite and
     the similarity's mean over the last 10 steps below the first 10's; dice
     and folding fraction must be finite.  The counts are read when the CLI
     returns.  After that, counted apart, the splat is launched through
     ``ops.warp_values_adjoint`` on the trained field, where
     <warp(v), c> = <v, splat(c)> must hold: no main path launches the
     splat yet (it is the warp's gradient in the moving image, which only
     the joint training will ask for).  One step's gradients through
     the kernels must agree with the same step on the plain versions.

Then the ``nvidia-smi`` line, the kernels summary line and, last,
``{"ok": true, "device": {...}}``.  Run with no arguments:
``python3 chip_smoke.py``.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s per type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# what each kernel replaces (the Pallas kernel's def line) and its source
KERNEL_INFO = {
    "conv3d_k3": ("deepatlas_torch/kernels/csrc/conv3d.cu",
                  "deepatlas_tpu/pallas/conv3d.py:170"),
    "deconv2x": ("deepatlas_torch/kernels/csrc/deconv3d.cu",
                 "deepatlas_tpu/pallas/deconv3d.py:55"),
    "conv3d_point": ("deepatlas_torch/kernels/csrc/conv3d.cu",
                     "deepatlas_tpu/pallas/conv3d.py:215"),
    "conv3d_k3_wgrad": ("deepatlas_torch/kernels/csrc/conv3d_wgrad.cu",
                        "deepatlas_tpu/pallas/conv3d.py:359"),
    "warp_trilinear": ("deepatlas_torch/kernels/csrc/warp.cu",
                       "deepatlas_tpu/pallas/warp.py:329"),
    "warp_grid_grad": ("deepatlas_torch/kernels/csrc/warp.cu",
                       "deepatlas_tpu/pallas/warp.py:415"),
    "splat_trilinear": ("deepatlas_torch/kernels/csrc/warp.cu",
                        "deepatlas_tpu/pallas/splat.py:106"),
}
PATHS = ("serving", "training", "registration")

# relative tolerances max|kernel - plain| / max|plain|: float32 differs
# only in summation order; bfloat16 inputs are identical on both sides and
# both accumulate in float32, so the outputs differ by at most the one
# final rounding to bfloat16 (2^-8 relative) plus summation order.
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# whole-net logits, relative to max|logit|: bf16 roundings compound over
# the 18 layers (measured 9.5e-3 on an H100); float32 differs only in
# summation order (measured 1.1e-6, so 1e-5 leaves a ninefold margin)
NET_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# one training step's parameter gradients, kernels against plain versions,
# per tensor relative to its largest entry.  float32 differs in summation
# order only, amplified by the BatchNorms' rsqrt(var + eps) on the way
# back (measured 1.7e-4 at worst on an H100).  In bfloat16 every layer's
# output and input gradient may flip one rounding, and 18 layers compound
# them: held in the mean over a tensor's entries (measured 4.6e-3 at worst);
# the largest single entry (measured 1.3e-2) is reported only.  A conv or deconv
# bias in front of a BatchNorm is left out: the batch mean removes it, so
# its gradient is zero by construction and holds rounding noise only.
GRAD_TOL = {"float32": 2e-3, "bfloat16_mean": 5e-2}
# the warp kernels against their plain versions, max|kernel - plain| /
# max|plain|.  Both sides compute the same float32 corner weights from the
# same float32 coordinates; they differ in the order of the 8 additions and
# in fused multiply-adds.  The warp's output is rounded once to the values'
# type (bf16: 2^-8).  The grid gradient and the splat are float32 whatever
# the values' type; the splat's atomics add up to a few dozen terms in any
# order.
WARP_TOL = {"warp_trilinear": {"float32": 1e-5, "bfloat16": 1e-2},
            "warp_grid_grad": {"float32": 1e-4, "bfloat16": 1e-4},
            "splat_trilinear": {"float32": 1e-5, "bfloat16": 1e-5}}
# one registration step's parameter gradients, kernels against plain
# versions, per tensor relative to its largest entry.  float32: summation
# order through 11 convs, the warp and LNCC's cancelling window sums, held
# at the worst entry.  bfloat16: every layer's output and input gradient may
# flip one rounding, the flips compound over 11 layers and move the sample
# coordinates of the warp; held in the mean over a tensor's entries and at
# the worst entry, each about ten times the larger of two readings on an
# H100 (5.9e-5 and 2.9e-6 in the mean, 1.8e-3 and 1.1e-4 at the worst
# entry, on two trained states; a typical entry is a tenth of the largest,
# so a zeroed or wrong tensor is far outside either).
REG_GRAD_TOL = {"float32": 2e-3, "bfloat16_mean": 1e-3, "bfloat16_max": 2e-2}
# <warp(v), c> against <v, splat(c)>, float32 sums of 5.6 M products
# accumulated in float64 on the card: relative difference
ADJOINT_TOL = 1e-4

TILE = 128
TILE_BATCH = 4
OAI_SHAPE = (160, 384, 384)
N_VOLUMES = 2
N_CLASSES = 5

# the training recipe of train_seg_torch.py
MB_SHAPE = (182, 218, 182)
MB_CROP = (0, 10, 7, 14, 8, 7)
TRAIN_SHAPE = tuple(MB_SHAPE[i] - MB_CROP[i] - MB_CROP[i + 3]
                    for i in range(3))
TRAIN_CLASSES = 32
N_TRAIN_VOLUMES = 4
TRAIN_STEPS = 42
# launches of one training step / one evaluated volume
STEP_LAUNCHES = {"conv3d_k3": 27, "deconv2x": 3, "conv3d_point": 2,
                 "conv3d_k3_wgrad": 14, "warp_trilinear": 0,
                 "warp_grid_grad": 0, "splat_trilinear": 0}
EVAL_LAUNCHES = {"conv3d_k3": 14, "deconv2x": 3, "conv3d_point": 1,
                 "conv3d_k3_wgrad": 0, "warp_trilinear": 0,
                 "warp_grid_grad": 0, "splat_trilinear": 0}

# the registration recipe of train_reg_torch.py
REG_ENC = (16, 32, 32, 32, 32)
REG_DEC = (32, 32, 32, 8, 8)
REG_MAX_DISP = 8
N_REG_TRAIN_VOLUMES = 4
N_REG_VALID_VOLUMES = 2
# launches of one registration step / one evaluated pair: 11 convs forward,
# 10 input gradients (the first conv's input is data), 11 weight gradients,
# the decoder's upsample to full resolution on the transposed-conv kernel
# (its backward is a matrix product), the warp and its grid gradient; the
# moving image needs no gradient, so no splat
REG_STEP_LAUNCHES = {"conv3d_k3": 21, "deconv2x": 1, "conv3d_point": 0,
                     "conv3d_k3_wgrad": 11, "warp_trilinear": 1,
                     "warp_grid_grad": 1, "splat_trilinear": 0}
REG_EVAL_LAUNCHES = {"conv3d_k3": 11, "deconv2x": 1, "conv3d_point": 0,
                     "conv3d_k3_wgrad": 0, "warp_trilinear": 1,
                     "warp_grid_grad": 0, "splat_trilinear": 0}


def log(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def unet_cases(path, batch, dhw, n_classes, train):
    """Every launch of one UNet_light forward (and, with ``train``, of its
    backward) on a ``(batch, *dhw, 1)`` input, as
    ``{(path, kernel, role, batch, dhw, cin, cout): launches}``.  Roles:
    ``forward``; ``dx`` (the same kernel on the upstream gradient, Cin and
    Cout swapped; the first conv's input needs none); ``wgrad``."""
    from deepatlas_torch.models import (UNET_LIGHT_DECODERS,
                                        UNET_LIGHT_ENCODERS)

    cases = {}

    def add(kernel, role, size, cin, cout):
        key = (path, kernel, role, batch, size, cin, cout)
        cases[key] = cases.get(key, 0) + 1

    def conv(size, cin, cout, first=False):
        add("conv3d_k3", "forward", size, cin, cout)
        if train:
            add("conv3d_k3_wgrad", "wgrad", size, cin, cout)
            if not first:
                add("conv3d_k3", "dx", size, cout, cin)

    cin, size, skips = 1, tuple(dhw), []
    for i, plan in enumerate(UNET_LIGHT_ENCODERS):
        for f in (plan if i == 0 else plan[1:]):
            conv(size, cin, f, first=cin == 1)
            cin = f
        if i < len(UNET_LIGHT_ENCODERS) - 1:
            skips.append(cin)
            size = tuple(n // 2 for n in size)
    for plan in UNET_LIGHT_DECODERS:
        add("deconv2x", "forward", size, cin, plan[0])
        size = tuple(n * 2 for n in size)
        cin = plan[0] + skips.pop()
        for f in plan[1:]:
            conv(size, cin, f)
            cin = f
    add("conv3d_point", "forward", size, cin, n_classes)
    if train:
        add("conv3d_point", "dx", size, n_classes, cin)
    return cases


def voxelmorph_cases(path, batch, dhw):
    """Every conv launch of one VoxelMorph training step on a
    ``(batch, *dhw)`` pair, keyed as ``unet_cases`` keys them; the size is
    the conv's input's.  A strided conv (roles ``forward_s2`` and
    ``wgrad_s2``) writes ``ceil(n / 2)`` voxels per axis; its input gradient
    (role ``dx_s2``) is the stride-1 kernel at the input's resolution on a
    zero-stuffed upstream gradient, but is bounded by what the function
    needs: the ``ceil(n / 2)`` gradient read once and 1/8 of the stride-1
    operations.  The decoder's upsample to full resolution is the
    transposed-conv kernel (timed on a random bank; its time and its byte
    bound do not depend on the bank's values)."""
    cases = {}

    def conv(size, cin, cout, first=False, stride=1):
        tag = "_s2" if stride == 2 else ""
        roles = [("conv3d_k3", "forward" + tag, cin, cout),
                 ("conv3d_k3_wgrad", "wgrad" + tag, cin, cout)]
        if not first:
            roles.append(("conv3d_k3", "dx" + tag, cout, cin))
        for kernel, role, a, b in roles:
            key = (path, kernel, role, batch, size, a, b)
            cases[key] = cases.get(key, 0) + 1

    sizes = [tuple(dhw)]
    for _ in range(4):
        sizes.append(tuple(-(-n // 2) for n in sizes[-1]))
    e, d = REG_ENC, REG_DEC
    conv(sizes[0], 2, e[0], first=True)
    for i in range(1, 5):
        conv(sizes[i - 1], e[i - 1], e[i], stride=2)
    conv(sizes[3], e[4], d[0])
    conv(sizes[2], d[0] + e[3], d[1])
    conv(sizes[1], d[1] + e[2], d[2])
    conv(sizes[1], d[2] + e[1], d[3])
    if all(2 * n == m for n, m in zip(sizes[1], sizes[0])):
        cases[(path, "deconv2x", "forward", batch, sizes[1], d[3], d[3])] = 1
    conv(sizes[0], d[3], d[4])
    conv(sizes[0], d[4] + e[0], 3)
    return cases


def all_cases():
    cases = unet_cases("serving", TILE_BATCH, (TILE,) * 3, N_CLASSES, False)
    cases.update(unet_cases("training", 1, TRAIN_SHAPE, TRAIN_CLASSES, True))
    cases.update(voxelmorph_cases("registration", 1, TRAIN_SHAPE))
    return cases


def work(kernel, n, cin, cout, dtype_name, n_out=None, role=""):
    """(flops, bytes) the function needs on ``n`` input voxels (and, for a
    strided k3 conv, ``n_out`` output voxels): each input read once, each
    output written once (weights as the float32 the kernels read; the
    weight gradient is written in float32).  Role ``dx_s2``, a strided
    conv's input gradient: ``n`` voxels of ``cout`` channels are written
    from ``n_out`` voxels of ``cin`` channels of upstream gradient."""
    s = 2 if dtype_name == "bfloat16" else 4
    if role == "dx_s2":
        return 2 * 27 * cin * cout * n_out, n_out * cin * s \
            + 27 * cin * cout * 4 + n * cout * s
    if kernel in ("conv3d_k3", "conv3d_k3_wgrad"):
        n_out = n if n_out is None else n_out
        return 2 * 27 * cin * cout * n_out, n * cin * s \
            + 27 * cin * cout * 4 + n_out * cout * s
    if kernel == "conv3d_point":
        return 2 * cin * cout * n, n * cin * s + cin * cout * 4 + n * cout * s
    return 2 * 8 * cin * cout * n, n * cin * s + 8 * cin * cout * 4 \
        + 8 * n * cout * s


def bound_ms(kernel, n, cin, cout, dtype_name, n_out=None, role=""):
    flops, nbytes = work(kernel, n, cin, cout, dtype_name, n_out, role)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_call(kernel, x, w, stride=1):
    """One PyTorch (cuDNN) call computing the same function: the yardstick
    for ``library_ms`` only; the port never calls it.  For the weight
    gradient ``w`` is the upstream gradient."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)           # NDHWC storage, NCDHW view
    if kernel == "conv3d_k3_wgrad":
        gc = w.permute(0, 4, 1, 2, 3)
        size = (w.shape[-1], x.shape[-1], 3, 3, 3)
        return lambda: torch.nn.grad.conv3d_weight(xc, size, gc,
                                                   stride=stride, padding=1)
    wk = w.to(x.dtype)
    if kernel == "conv3d_k3":
        return lambda: F.conv3d(xc, wk.permute(4, 3, 0, 1, 2), stride=stride,
                                padding=1)
    if kernel == "conv3d_point":
        return lambda: F.conv3d(xc, wk.permute(1, 0)[:, :, None, None, None])
    return lambda: F.conv_transpose3d(xc, wk.permute(3, 4, 0, 1, 2), stride=2)


def check_kernels(seed):
    """Phase 3, convolutions: each against its plain version at every shape
    of the three paths in both types.  Returns ``{kernel: {"max_abs_err",
    path: {ms, plain_ms, library_ms, bound_ms, flops, bytes}}}`` with the
    bfloat16 totals of one unit of each path (a tile batch; a training
    step); the warp kernels' entries are filled by ``check_warp_kernels``."""
    import torch

    from deepatlas_torch.kernels import KERNELS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "flops", "bytes")
    summary = {name: dict({path: dict.fromkeys(keys, 0.0) for path in PATHS},
                          max_abs_err=0.0)
               for name in KERNELS}
    for (path, name, role, batch, size, cin, cout), per_unit in \
            all_cases().items():
        fn, plain = KERNELS[name]
        n = batch * int(np.prod(size))
        big = n * max(cin, cout) > 2e8      # fewer repeats on the largest
        # the strided layers' input gradient runs the stride-1 kernel
        stride = 2 if role in ("forward_s2", "wgrad_s2") else 1
        kw = {"stride": 2} if stride == 2 else {}
        out_size = tuple(-(-v // stride) for v in size)
        n_out = batch * int(np.prod(
            [-(-v // 2) for v in size] if role == "dx_s2" else out_size))
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = (torch.rand((batch,) + size + (cin,), generator=gen,
                            device="cuda") * 2 - 1).to(dtype)
            if name == "conv3d_k3_wgrad":
                second = (torch.rand((batch,) + out_size + (cout,),
                                     generator=gen, device="cuda") * 2
                          - 1).to(dtype)
                args = timed_args = (x, second)
            else:
                wshape = {"conv3d_k3": (3, 3, 3, cin, cout),
                          "deconv2x": (2, 2, 2, cin, cout),
                          "conv3d_point": (cin, cout)}[name]
                fan = cin * (27 if name == "conv3d_k3" else 1)
                second = torch.randn(wshape, generator=gen, device="cuda") \
                    / np.sqrt(fan)
                bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
                args, timed_args = (x, second, bias), (x, second)
            got = fn(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name} {tuple(x.shape)}: kernel gives "
                                     f"{tuple(got.shape)} {got.dtype}, plain "
                                     f"{tuple(ref.shape)} {ref.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # the weight gradient is float32 from the same float32 products
            # in both types (bf16 products are exact in float32)
            tol = TOL["float32"] if name == "conv3d_k3_wgrad" else TOL[dname]
            ok = bool(np.isfinite(err)) and err <= tol * scale
            del got, ref
            ms = cuda_ms(lambda: fn(*timed_args, **kw), reps=3 if big else 5)
            plain_ms = cuda_ms(lambda: plain(*timed_args, **kw),
                               reps=1 if big else 2, warmup=0 if big else 1)
            lib_ms = cuda_ms(library_call(name, x, second, stride),
                             reps=3 if big else 5)
            bms, bound_by = bound_ms(name, n, cin, cout, dname, n_out, role)
            log({"phase": "kernels", "path": path, "kernel": name,
                 "role": role, "dtype": dname, "x": list(x.shape),
                 "cin": cin, "cout": cout, "launches_per_unit": per_unit,
                 "max_abs_err": err, "max_abs_ref": scale,
                 "rel_tol": tol, "ok": ok, "kernel_ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bms, "bound_by": bound_by})
            if not ok:
                raise AssertionError(f"{name} {role} {dname} "
                                     f"{tuple(x.shape)} -> {cout}: max|k-p| "
                                     f"{err} > {tol} * {scale}")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
            if dname == "bfloat16":       # the main paths' type, per unit
                flops, nbytes = work(name, n, cin, cout, dname, n_out, role)
                tot = summary[name][path]
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", bms),
                                 ("flops", flops), ("bytes", nbytes)):
                    tot[key] += per_unit * val
            del x, second, args, timed_args
    torch.cuda.empty_cache()
    return summary


def check_upsample(seed):
    """Phase 3, the VoxelMorph decoder's upsample to full resolution: the
    transposed-conv kernel on the identity bank (``nearest_up2x``) against
    ``nearest_resize`` at the step's shape, which it must equal bit for bit
    in both types (every tap copies its input voxel)."""
    import torch

    from deepatlas_torch.kernels import nearest_up2x
    from deepatlas_torch.ops import nearest_resize

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    half = tuple(-(-n // 2) for n in TRAIN_SHAPE)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.rand((1,) + half + (REG_DEC[3],), generator=gen,
                        device="cuda") * 2 - 1).to(dtype)
        got = nearest_up2x(x)
        ref = nearest_resize(x, TRAIN_SHAPE)
        torch.cuda.synchronize()
        same = got.shape == ref.shape and got.dtype == ref.dtype \
            and torch.equal(got, ref)
        del got, ref
        ms = cuda_ms(lambda: nearest_up2x(x), reps=5)
        resize_ms = cuda_ms(lambda: nearest_resize(x, TRAIN_SHAPE), reps=5)
        log({"phase": "kernels", "path": "registration",
             "kernel": "deconv2x", "role": "nearest_up2x (identity bank)",
             "dtype": str(dtype).split(".")[1], "x": list(x.shape),
             "equals_nearest_resize": same, "kernel_ms": ms,
             "nearest_resize_ms": resize_ms})
        if not same:
            raise AssertionError(f"nearest_up2x {dtype} differs from "
                                 f"nearest_resize at {tuple(x.shape)}")
        del x
    torch.cuda.empty_cache()


def smooth_grid(shape, amplitude_vox, seed):
    """A deformation grid ``(B, D, H, W, 3)`` on the card: the identity plus
    a low-frequency sinusoidal displacement of up to ``amplitude_vox`` voxels
    per axis (phases from ``seed``)."""
    import torch

    from deepatlas_torch.ops import identity_grid_batch, normalize_displacement

    b, d, h, w = shape
    rng = np.random.RandomState(seed)
    zz, yy, xx = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device="cuda")
          for n in (d, h, w)], indexing="ij")
    comps = []
    for _ in range(3):
        f = rng.uniform(0.5, 1.5, 3) * 2 * np.pi / np.array([61.0, 47.0, 53.0])
        ph = rng.uniform(0, 2 * np.pi, 2)
        comps.append(amplitude_vox * torch.sin(f[0] * zz + f[1] * yy + ph[0])
                     * torch.cos(f[2] * xx + ph[1]))
    disp = normalize_displacement(torch.stack(comps, dim=-1))[None]
    grid = disp.expand(b, -1, -1, -1, -1) + identity_grid_batch(
        shape, device="cuda")
    return grid.contiguous()


def warp_bytes(kernel, n, c, elem):
    """Bytes the function must move on ``n`` sample points: 12 of
    coordinates per point; the warp reads one value of the volume and
    writes one per point and channel; the grid gradient reads the volume
    and the upstream gradient and writes 12; the splat reads the upstream
    gradient and writes a float32 volume that it first zero-fills."""
    if kernel == "warp_trilinear":
        return n * (12 + 2 * elem * c)
    if kernel == "warp_grid_grad":
        return n * (12 + 2 * elem * c + 12)
    return n * (12 + elem * c + 2 * 4 * c)


def check_warp_kernels(summary, seed):
    """Phase 3, warp kernels: E, F and G against their plain versions, with
    kernel / plain / library (``F.grid_sample``, timed on float32 values:
    it wants the grid in the values' type, and a bfloat16 grid cannot
    address 168 voxels) times.  Its one backward call computes both the
    grid gradient and the splat, so that time stands beside each of them.
    Fills ``summary`` with the float32 one-channel smooth-field case, the
    registration step's call."""
    import torch
    import torch.nn.functional as F

    from deepatlas_torch import kernels
    from deepatlas_torch.ops import clamp_displacement

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    full = (1,) + TRAIN_SHAPE
    cases = [("smooth", full, 1, torch.float32, 2.5),
             ("saturated", full, 1, torch.float32, 20.0),
             ("smooth", full, 2, torch.bfloat16, 2.5),
             ("saturated", full, 2, torch.bfloat16, 20.0),
             ("odd", (2, 13, 17, 11), 3, torch.float32, 3.0)]
    for field, shape, c, dtype, amp in cases:
        dname = str(dtype).split(".")[1]
        big = shape == full
        grid = clamp_displacement(smooth_grid(shape, amp, seed),
                                  REG_MAX_DISP).contiguous()
        vol = torch.rand(shape + (c,), generator=gen, device="cuda").to(dtype)
        ct = (torch.rand(shape + (c,), generator=gen, device="cuda") * 2
              - 1).to(dtype)
        n = int(np.prod(shape))
        vol_l = vol.float().permute(0, 4, 1, 2, 3).requires_grad_(True)
        grid_l = grid.clone().requires_grad_(True)
        ct_l = ct.float().permute(0, 4, 1, 2, 3)
        out_l = F.grid_sample(vol_l, grid_l, mode="bilinear",
                              padding_mode="zeros", align_corners=True)
        calls = {
            "warp_trilinear": (
                lambda: kernels.warp_trilinear(vol, grid),
                lambda: kernels.warp_trilinear_plain(vol, grid),
                lambda: F.grid_sample(vol_l.detach(), grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)),
            "warp_grid_grad": (
                lambda: kernels.warp_grid_grad(vol, grid, ct),
                lambda: kernels.warp_grid_grad_plain(vol, grid, ct),
                lambda: torch.autograd.grad(out_l, (vol_l, grid_l), ct_l,
                                            retain_graph=True)),
            "splat_trilinear": (
                lambda: kernels.splat_trilinear(ct, grid, shape[1:]),
                lambda: kernels.splat_trilinear_plain(ct, grid, shape[1:]),
                lambda: torch.autograd.grad(out_l, (vol_l, grid_l), ct_l,
                                            retain_graph=True)),
        }
        for name, (fn, plain, library) in calls.items():
            got, ref = fn(), plain()
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name} {shape} C={c}: kernel gives "
                                     f"{tuple(got.shape)} {got.dtype}, plain "
                                     f"{tuple(ref.shape)} {ref.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = WARP_TOL[name][dname]
            ok = bool(np.isfinite(err)) and err <= tol * scale
            del got, ref
            ms = cuda_ms(fn, reps=5)
            plain_ms = cuda_ms(plain, reps=2 if big else 3)
            lib_ms = cuda_ms(library, reps=5)
            nbytes = warp_bytes(name, n, c, 2 if dname == "bfloat16" else 4)
            bms = nbytes / HBM_BYTES_PER_S * 1e3
            log({"phase": "kernels", "path": "registration", "kernel": name,
                 "field": field, "dtype": dname, "vol": list(vol.shape),
                 "max_disp": REG_MAX_DISP, "max_abs_err": err,
                 "max_abs_ref": scale, "rel_tol": tol, "ok": ok,
                 "kernel_ms": ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "library": "F.grid_sample forward"
                 if name == "warp_trilinear" else
                 "F.grid_sample backward (grid gradient and splat in one)",
                 "bound_ms": bms, "bound_by": "bytes"})
            if not ok:
                raise AssertionError(f"{name} {field} {dname} {shape} C={c}: "
                                     f"max|k-p| {err} > {tol} * {scale}")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
            if big and field == "smooth" and dtype == torch.float32:
                summary[name]["registration"].update(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, flops=0.0, bytes=float(nbytes))
        del out_l, vol_l, grid_l, ct_l, calls

        # the differentiable entry point: dvol through the splat and dgrid
        # through the grid gradient, the clamp's mask included, against the
        # same Function on the plain versions
        raw = smooth_grid(shape, amp, seed)
        grads = []
        for use_plain in (False, True):
            v = vol.clone().requires_grad_(True)
            g = raw.clone().requires_grad_(True)
            with plain_math() if use_plain else contextlib.nullcontext():
                out = kernels.grid_sample(v, g, max_disp=REG_MAX_DISP)
                grads.append(torch.autograd.grad(out, (v, g), ct))
        torch.cuda.synchronize()
        errs = {}
        for key, got, ref, tol in zip(
                ("dvol", "dgrid"), grads[0], grads[1],
                (max(WARP_TOL["splat_trilinear"][dname],
                     WARP_TOL["warp_trilinear"][dname]),
                 WARP_TOL["warp_grid_grad"][dname])):
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            errs[key] = {"max_abs_err": err, "max_abs_ref": scale,
                         "rel_tol": tol, "ok": err <= tol * scale}
        saturated = (grads[0][1] == 0).all(dim=-1).float().mean().item()
        log({"phase": "kernels", "path": "registration",
             "kernel": "grid_sample (entry point)", "field": field,
             "dtype": dname, "vol": list(vol.shape), "gradients": errs,
             "points_without_grid_gradient": saturated})
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"grid_sample gradients {field} {dname}: "
                                 f"{errs}")
        del grads, vol, ct, grid, raw
    torch.cuda.empty_cache()


def write_corpus(root, seed):
    """Synthetic OAI-ZIB volumes: nested ellipsoidal shells labelled 0..4
    with intensities that follow the labels, plus noise."""
    from deepatlas_torch.data import write_nifti

    rng = np.random.RandomState(seed)
    d, h, w = OAI_SHAPE
    zz, yy, xx = np.meshgrid(np.linspace(-1, 1, d, dtype=np.float32),
                             np.linspace(-1, 1, h, dtype=np.float32),
                             np.linspace(-1, 1, w, dtype=np.float32),
                             indexing="ij")
    names = []
    for v in range(N_VOLUMES):
        c = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
        r = np.sqrt(((zz - c[0]) / 0.9) ** 2 + ((yy - c[1]) / 0.8) ** 2
                    + ((xx - c[2]) / 0.8) ** 2)
        seg = np.clip(4 - np.floor(r * 5), 0, 4).astype(np.uint8)
        img = (seg.astype(np.float32) / 5 + 0.1
               + 0.05 * rng.randn(d, h, w).astype(np.float32))
        name = f"synth_{v}_{'LEFT' if v % 2 else 'RIGHT'}"
        write_nifti(os.path.join(root, f"{name}_image.nii.gz"), img)
        write_nifti(os.path.join(root, f"{name}_masks.nii.gz"), seg)
        names.append(name)
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names


def seeded_state(model, seed):
    """Random weights (glorot scale) and non-trivial BatchNorm statistics
    from a numpy seed."""
    import torch

    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("running_mean") or k.endswith("bias"):
            a = 0.1 * rng.randn(*shape)
        elif k.endswith("bn.weight"):
            a = 1 + 0.1 * rng.randn(*shape)
        else:
            fan = np.prod(shape[:-2]) * (shape[-2] + shape[-1])
            a = rng.randn(*shape) * np.sqrt(2.0 / fan)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def net_agreement(model, tiles):
    """Logits of one tile batch through the kernels against the same net on
    the plain versions, both on the card."""
    import torch

    from deepatlas_torch.kernels import (conv3d_k3_plain, conv3d_point_plain,
                                         deconv2x_plain)
    from deepatlas_torch.models import layers, unet

    with torch.inference_mode():
        got = model(tiles).float()
        with mock.patch.object(layers, "conv3d_k3", conv3d_k3_plain), \
                mock.patch.object(layers, "deconv2x", deconv2x_plain), \
                mock.patch.object(unet, "conv3d_point", conv3d_point_plain):
            ref = model(tiles).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits from the kernel path")
    err = (got - ref).abs().max().item()
    return err, ref.abs().max().item()


def stage_seconds(model, workdir, name):
    """Host clock of each stage of one volume's inference, run one after
    the other (the CLI overlaps decoding with the previous volume)."""
    import torch

    from deepatlas_torch.data import (Compose, Partition, VolumeToArray,
                                      get_seg_dataset)
    from deepatlas_torch.train import make_tile_predictor, volume_dice

    dataset = get_seg_dataset("OAI")(os.path.join(workdir, "test.txt"),
                                     workdir, pre_transform=Compose(
                                         [VolumeToArray()]))
    predict = make_tile_predictor(model, TILE_BATCH)
    device = next(model.parameters()).device
    out = {}
    t = time.perf_counter()

    def lap(key):
        nonlocal t
        if device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        out[key] = now - t
        t = now

    sample = dataset[dataset.name_list.index(name)]
    lap("read_nifti")
    part = Partition((TILE,) * 3, (16,) * 3)
    tiles = part({"image": sample["image"]})["image"]
    lap("partition")
    labels = predict(tiles)
    lap("predict_tiles")
    pred = part.assemble(labels, data_type=np.uint8)
    lap("assemble")
    volume_dice(pred, sample["segmentation"], N_CLASSES, device)
    lap("dice")
    return out


def run_main_path(seed, workdir):
    import torch

    import infer_seg_torch
    from deepatlas_torch.data import Partition, read_nifti
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import save_checkpoint

    t0 = time.perf_counter()
    names = write_corpus(workdir, seed)
    model = get_network("UNet_light")(in_channel=1, n_classes=N_CLASSES,
                                      bias=True, BN=True,
                                      dtype=torch.bfloat16)
    sd = seeded_state(model, seed)
    ckpt = save_checkpoint({"epoch": 0, "best_score": 0.0, "model": sd},
                           True, os.path.join(workdir, "ckpt"))
    setup_s = time.perf_counter() - t0

    argv = ["--ckpt", os.path.join(os.path.dirname(ckpt), "model_best"),
            "--data-root", workdir, "--list-file",
            os.path.join(workdir, "test.txt"), "--data", "OAI",
            "--n-classes", str(N_CLASSES), "--tile-size", *[str(TILE)] * 3,
            "--overlap", "16", "16", "16", "--tile-batch", str(TILE_BATCH),
            "--flip-left", "--device", "cuda"]
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        infer_seg_torch.main(argv)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    per_volume = [ln for ln in lines if "name" in ln]
    means = [ln for ln in lines if "mean_dice_avg" in ln]
    if [ln["name"] for ln in per_volume] != names or len(means) != 1:
        raise AssertionError(f"unexpected CLI output: {out.getvalue()!r}")
    for ln in per_volume + means:
        vals = ln.get("dice", ln.get("mean_dice_per_class"))
        if len(vals) != N_CLASSES - 1 or not np.all(np.isfinite(vals)):
            raise AssertionError(f"bad dice line {ln}")

    # tiles per volume from the partition of the OAI shape
    eff = TILE - 2 * 16
    n_tiles = int(np.prod([-(-s // eff) for s in OAI_SHAPE]))
    batches = N_VOLUMES * -(-n_tiles // TILE_BATCH)
    want = {k: v * batches for k, v in EVAL_LAUNCHES.items()}
    log({"phase": "main", "volumes": N_VOLUMES, "volume_shape": OAI_SHAPE,
         "tiles_per_volume": n_tiles, "tile_batches": batches,
         "launches": counts, "launches_expected": want,
         "setup_s": setup_s, "infer_s": infer_s,
         "seconds_per_volume": infer_s / N_VOLUMES,
         "tiles_per_s": N_VOLUMES * n_tiles / infer_s,
         "max_memory_allocated": peak, "cli_lines": lines})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")

    model.load_state_dict(sd)
    model.to("cuda").eval()
    stages = stage_seconds(model, workdir, names[0])

    # one tile batch: kernels against the plain versions, bf16 and f32
    img = read_nifti(os.path.join(workdir, f"{names[0]}_image.nii.gz")).data
    tiles = Partition((TILE,) * 3, (16,) * 3)(
        {"image": np.clip(img, 0, 1)[..., None]})["image"][:TILE_BATCH]
    x = torch.from_numpy(np.ascontiguousarray(tiles)).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x), reps=3)
    agree = {}
    for dtype in (torch.bfloat16, None):
        model.dtype = dtype
        err, scale = net_agreement(model, x)
        dname = "bfloat16" if dtype else "float32"
        agree[dname] = {"max_abs_err": err, "max_abs_logit": scale,
                        "rel_tol": NET_TOL[dname]}
        if not err <= NET_TOL[dname] * scale:
            raise AssertionError(f"net {dname}: max|k-p| {err} > "
                                 f"{NET_TOL[dname]} * {scale}")
    log({"phase": "main_check", "tile_batch_forward_ms_bf16": fwd_ms,
         "stage_s": stages, "logits_vs_plain": agree,
         "mean_dice": means[0]})
    return counts


def write_mindboggle_corpus(root, seed, shape=MB_SHAPE,
                            n_train=N_TRAIN_VOLUMES):
    """Synthetic MindBoggle-layout corpus under ``root/mindboggle``: each
    volume is a 4 x 4 x 2 grid of blocks labelled 0..31 (block borders
    jittered per volume) whose intensity follows the label, plus noise, so a
    few dozen steps learn it.  Name lists as ``train_seg_torch.py`` expects
    them: the first ``n_train`` volumes train, the last one validates and
    tests."""
    from deepatlas_torch.data import write_nifti

    rng = np.random.RandomState(seed)
    mb = os.path.join(root, "mindboggle")
    img_dir = os.path.join(mb, "image_in_MNI152_normalized")
    seg_dir = os.path.join(mb, "label_31_reID_merged")
    os.makedirs(img_dir)
    os.makedirs(seg_dir)
    names = [f"synth_{v}" for v in range(n_train + 1)]
    for name in names:
        index = []
        for n, blocks in zip(shape, (4, 4, 2)):
            cuts = (np.arange(1, blocks) / blocks
                    + rng.uniform(-0.04, 0.04, blocks - 1)) * n
            index.append(np.searchsorted(cuts, np.arange(n)))
        seg = ((index[0][:, None, None] * 4 + index[1][None, :, None]) * 2
               + index[2][None, None, :]).astype(np.uint8)
        img = ((seg.astype(np.float32) + 1) / (TRAIN_CLASSES + 1)
               + 0.005 * rng.standard_normal(shape).astype(np.float32))
        write_nifti(os.path.join(img_dir, f"{name}.nii.gz"), img)
        write_nifti(os.path.join(seg_dir, f"{name}.nii.gz"), seg)
    lists = {"MMRR-21-flip.txt": names[:n_train],
             "NKI-RS-21-valid.txt": names[n_train:],
             "NKI-RS-21-train.txt": names[n_train:]}
    for fname, members in lists.items():
        with open(os.path.join(mb, fname), "w") as f:
            f.write("".join(f"{n}\n" for n in members))
    return names


@contextlib.contextmanager
def plain_math():
    """Run the wrappers' autograd Functions on the plain versions' math on
    the card (for the comparison only: nothing in the port does this)."""
    from deepatlas_torch.kernels import conv3d, deconv3d, warp

    with mock.patch.object(conv3d, "_k3_cuda", conv3d._k3_math), \
            mock.patch.object(conv3d, "_wgrad_cuda", conv3d._wgrad_math), \
            mock.patch.object(conv3d, "_point_cuda", conv3d._point_math), \
            mock.patch.object(deconv3d, "_deconv_cuda",
                              deconv3d._deconv_math), \
            mock.patch.object(warp, "_warp_cuda", warp._warp_math), \
            mock.patch.object(warp, "_grid_grad_cuda",
                              warp._grid_grad_math), \
            mock.patch.object(warp, "_splat_cuda", warp._splat_math):
        yield


class StepRecorder:
    """Wraps an experiment's step factories to record, per training step,
    its loss (``loss_of`` the step's return value), its seconds
    (synchronised) and the kernels it launched, and per evaluated volume or
    pair its launches."""

    def __init__(self, loss_of=lambda out: float(out[1])):
        self.loss_of = loss_of
        self.losses, self.seconds, self.step_launches = [], [], []
        self.eval_launches = []
        self.first_start = self.last_end = None

    def _delta(self, before):
        from deepatlas_torch.kernels import launch_counts

        return {k: v - before[k] for k, v in launch_counts().items()}

    def train_factory(self, make):
        import torch

        from deepatlas_torch.kernels import launch_counts

        def factory(*args, **kwargs):
            step = make(*args, **kwargs)

            def recorded(state, *tensors):
                before = launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if self.first_start is None:
                    self.first_start = t0
                out = step(state, *tensors)
                torch.cuda.synchronize()
                self.last_end = time.perf_counter()
                self.seconds.append(self.last_end - t0)
                self.losses.append(self.loss_of(out))
                self.step_launches.append(self._delta(before))
                return out

            return recorded

        return factory

    def eval_factory(self, make):
        from deepatlas_torch.kernels import launch_counts

        def factory(n_class):
            step = make(n_class)

            def recorded(state, *tensors):
                before = launch_counts()
                out = step(state, *tensors)
                self.eval_launches.append(self._delta(before))
                return out

            return recorded

        return factory


def step_breakdown(model, criterion, optimizer, x, y):
    """Seconds of one synchronised training step, split into forward (with
    the loss), backward and optimizer."""
    import torch

    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()

    def lap(key):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[key] = now - t
        t = now

    optimizer.zero_grad(set_to_none=True)
    loss = criterion(model(x, train=True).float(), y)
    lap("forward_and_loss")
    loss.backward()
    lap("backward")
    optimizer.step()
    lap("optimizer")
    return out


def step_gradients(model, criterion, x, y):
    """Parameter gradients of one training step (BatchNorm statistics are
    put back, so repeated calls start from the same state)."""
    import torch

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.zero_grad(set_to_none=True)
    loss = criterion(model(x, train=True).float(), y)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    return loss.item(), grads


def run_train_path(seed, workdir):
    import torch

    import train_seg_torch
    from deepatlas_torch.data import (Compose, CropVolume, VolumeToArray,
                                      get_seg_dataset)
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import (load_checkpoint, make_optimizer,
                                       segmentation)

    t0 = time.perf_counter()
    names = write_mindboggle_corpus(workdir, seed)
    setup_s = time.perf_counter() - t0

    argv = ["--data-root", workdir, "--log-root", "logs", "--num-samples",
            "21", "--num-epochs", "1", "--device", "cuda"]
    rec = StepRecorder()
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(out), \
            mock.patch.object(segmentation, "make_seg_train_step",
                              rec.train_factory(
                                  segmentation.make_seg_train_step)), \
            mock.patch.object(segmentation, "make_seg_eval_step",
                              rec.eval_factory(
                                  segmentation.make_seg_eval_step)):
        dice_per_class, dice_avg = train_seg_torch.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n_eval = len(rec.eval_launches)
    want = {k: TRAIN_STEPS * STEP_LAUNCHES[k] + n_eval * EVAL_LAUNCHES[k]
            for k in STEP_LAUNCHES}
    run_dirs = [os.path.join(dp, "checkpoint")
                for dp, _, files in os.walk(os.path.join(workdir, "logs"))
                if "checkpoint" in files]
    warm = sorted(rec.seconds[2:])
    train_wall = rec.last_end - rec.first_start
    log({"phase": "train", "volume_shape": MB_SHAPE,
         "train_shape": TRAIN_SHAPE, "n_classes": TRAIN_CLASSES,
         "train_volumes": N_TRAIN_VOLUMES, "steps": len(rec.losses),
         "evaluated_volumes": n_eval, "launches": counts,
         "launches_expected": want, "launches_per_step": STEP_LAUNCHES,
         "losses": rec.losses,
         "loss_first10_mean": float(np.mean(rec.losses[:10])),
         "loss_last10_mean": float(np.mean(rec.losses[-10:])),
         "first_steps_s": rec.seconds[:2],
         "step_s_median": warm[len(warm) // 2], "step_s_min": warm[0],
         "step_s_max": warm[-1],
         "volumes_per_s_in_steps": 1.0 / (sum(warm) / len(warm)),
         "volumes_per_s_with_loading": len(rec.losses) / train_wall,
         "setup_s": setup_s, "cli_s": total_s,
         "max_memory_allocated": peak, "test_dice_avg": float(dice_avg),
         "checkpoints": [os.path.relpath(d, workdir) for d in run_dirs],
         "cli_tail": out.getvalue().splitlines()[-6:]})
    if len(rec.losses) != TRAIN_STEPS or n_eval != 2:
        raise AssertionError(f"{len(rec.losses)} steps and {n_eval} "
                             f"evaluated volumes, expected {TRAIN_STEPS}, 2")
    for i, got in enumerate(rec.step_launches):
        if got != STEP_LAUNCHES:
            raise AssertionError(f"step {i} launched {got}, expected "
                                 f"{STEP_LAUNCHES}")
    for got in rec.eval_launches:
        if got != EVAL_LAUNCHES:
            raise AssertionError(f"an evaluation launched {got}, expected "
                                 f"{EVAL_LAUNCHES}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not np.all(np.isfinite(rec.losses)):
        raise AssertionError(f"non-finite loss in {rec.losses}")
    if not np.mean(rec.losses[-10:]) < np.mean(rec.losses[:10]):
        raise AssertionError(f"the loss did not fall: {rec.losses}")
    if len(run_dirs) != 1:
        raise AssertionError(f"expected one checkpoint, found {run_dirs}")
    if dice_per_class.shape != (TRAIN_CLASSES - 1,) \
            or not np.all(np.isfinite(dice_per_class)):
        raise AssertionError(f"bad test dice {dice_per_class}")

    # one more step by hand on the trained state: where its time goes, and
    # its gradients through the kernels against the plain versions
    mb = os.path.join(workdir, "mindboggle")
    dataset = get_seg_dataset("MindBoggle")(
        os.path.join(mb, "MMRR-21-flip.txt"), mb, pre_transform=Compose(
            [VolumeToArray(), CropVolume(MB_CROP)]))
    sample = dataset[0]
    x = torch.from_numpy(np.ascontiguousarray(sample["image"])[None]).cuda()
    y = torch.from_numpy(np.ascontiguousarray(
        sample["segmentation"])[None]).cuda()
    model = get_network("UNet_light")(in_channel=1, n_classes=TRAIN_CLASSES,
                                      bias=True, BN=True,
                                      dtype=torch.bfloat16)
    model.load_state_dict(load_checkpoint(run_dirs[0])["model"])
    model.cuda()
    criterion = get_loss_function("dice")(
        n_class=TRAIN_CLASSES, weight_type="Uniform", no_bg=False,
        softmax=True, eps=1e-6)
    optimizer = make_optimizer(model, 1e-3)
    step_breakdown(model, criterion, optimizer, x, y)       # warm-up
    split = step_breakdown(model, criterion, optimizer, x, y)

    agree = {}
    for dtype in (torch.bfloat16, None):
        model.dtype = dtype
        dname = "bfloat16" if dtype else "float32"
        loss_k, got = step_gradients(model, criterion, x, y)
        with plain_math():
            loss_p, ref = step_gradients(model, criterion, x, y)
        worst_max, worst_mean = (0.0, ""), (0.0, "")
        for name, r in ref.items():
            if name.endswith(".bias") and ".bn." not in name \
                    and not name.startswith("head."):
                continue        # in front of a BatchNorm: noise only
            scale = r.abs().max().item()
            diff = (got[name] - r).abs()
            if not torch.isfinite(diff).all():
                raise AssertionError(f"non-finite gradient in {name}")
            worst_max = max(worst_max, (diff.max().item() / scale, name))
            worst_mean = max(worst_mean, (diff.mean().item() / scale, name))
        agree[dname] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                        "worst_max_rel": worst_max,
                        "worst_mean_rel": worst_mean}
        if dtype is None:
            agree[dname]["rel_tol_max"] = GRAD_TOL["float32"]
            bad = worst_max[0] > GRAD_TOL["float32"]
        else:
            agree[dname]["rel_tol_mean"] = GRAD_TOL["bfloat16_mean"]
            bad = worst_mean[0] > GRAD_TOL["bfloat16_mean"]
        agree[dname]["ok"] = not (bad or abs(loss_k - loss_p)
                                  > NET_TOL[dname])
    log({"phase": "train_check", "step_split_s": split,
         "gradients_vs_plain": agree, "volume": names[0]})
    if not all(a["ok"] for a in agree.values()):
        raise AssertionError(f"step gradients disagree: {agree}")
    return counts


def write_reg_corpus(root, seed, shape=MB_SHAPE, max_shift=3.0,
                     intensity=0.3):
    """Synthetic MindBoggle-layout registration corpus under
    ``root/mindboggle``: every volume is one textured base (a sum of
    sinusoids with wavelengths of 0.1-0.2 of a side, so that every 9^3
    window has structure) labelled by a 4 x 4 x 2 grid of blocks, seen
    through its own smooth deformation of up to ``max_shift`` voxels per
    axis -- image and labels are evaluated at the displaced coordinates, so
    a registration has a few voxels to recover and a few dozen steps can
    learn to.  Intensities are ``intensity`` of full scale (mean 0.15): an
    untrained VoxelMorph has no bias yet, so its field is proportional to
    its input, and on full-scale images it starts far past the 8-voxel
    clamp at every voxel, where the clamp passes no gradient and the
    similarity cannot move (measured on an H100: ``disp_overflow`` 1.0 and
    a constant similarity over all 42 steps at ``intensity=1``).  The first
    4 volumes train; the last 2 validate and test (two volumes make two
    ordered pairs)."""
    from deepatlas_torch.data import write_nifti

    rng = np.random.RandomState(seed)
    mb = os.path.join(root, "mindboggle")
    img_dir = os.path.join(mb, "image_in_MNI152_normalized")
    seg_dir = os.path.join(mb, "label_31_reID_merged")
    os.makedirs(img_dir)
    os.makedirs(seg_dir)
    # coordinates as fractions of each side, so that a cut-down shape (the
    # tests') has the same picture
    frac = np.meshgrid(*[np.arange(n, dtype=np.float32) / n for n in shape],
                       indexing="ij")
    waves = [(rng.uniform(5, 10, 3) * rng.choice([-1, 1], 3),
              rng.uniform(0, 2 * np.pi)) for _ in range(4)]
    n_train = N_REG_TRAIN_VOLUMES
    names = [f"synth_{v}" for v in range(n_train + N_REG_VALID_VOLUMES)]
    for name in names:
        at = []
        for axis, n in enumerate(shape):
            k = rng.uniform(0.7, 1.6, 3)
            ph = rng.uniform(0, 2 * np.pi, 3)
            shift = max_shift / n * (
                np.sin(2 * np.pi * k[0] * frac[0] + ph[0])
                * np.sin(2 * np.pi * k[1] * frac[1] + ph[1])
                * np.sin(2 * np.pi * k[2] * frac[2] + ph[2]))
            at.append((frac[axis] + shift).astype(np.float32))
        img = np.full(shape, 0.5 * intensity, np.float32)
        for k, ph in waves:
            img += np.float32(0.11 * intensity) * np.sin(
                2 * np.pi * (k[0] * at[0] + k[1] * at[1] + k[2] * at[2])
                + ph).astype(np.float32)
        index = [np.clip(np.floor(a * blocks), 0, blocks - 1).astype(np.int64)
                 for a, blocks in zip(at, (4, 4, 2))]
        seg = ((index[0] * 4 + index[1]) * 2 + index[2]).astype(np.uint8)
        write_nifti(os.path.join(img_dir, f"{name}.nii.gz"),
                    np.clip(img, 0, 1))
        write_nifti(os.path.join(seg_dir, f"{name}.nii.gz"), seg)
    lists = {"MMRR-21-flip.txt": names[:n_train],
             "NKI-RS-21-valid.txt": names[n_train:],
             "NKI-RS-21-train.txt": names[n_train:]}
    for fname, members in lists.items():
        with open(os.path.join(mb, fname), "w") as f:
            f.write("".join(f"{n}\n" for n in members))
    return names


def reg_step_gradients(model, sim_loss, reg_loss, moving, fixed):
    """Loss terms and parameter gradients of one registration step."""
    import torch

    model.zero_grad(set_to_none=True)
    disp, warped, _ = model(moving, fixed, train=True)
    sim = sim_loss(warped.float(), fixed.float())
    reg = reg_loss(disp.float())
    (sim + reg).backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return sim.item(), reg.item(), grads


def reg_step_breakdown(model, sim_loss, reg_loss, optimizer, moving, fixed):
    """Seconds of one synchronised registration step, split into the
    network, the warp, the two losses, backward and optimizer."""
    import torch

    from deepatlas_torch.kernels import grid_sample
    from deepatlas_torch.ops import identity_grid_batch

    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()

    def lap(key):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[key] = now - t
        t = now

    optimizer.zero_grad(set_to_none=True)
    disp = model.trunk(moving, fixed, train=True)
    lap("trunk_forward")
    deform = disp + identity_grid_batch(moving.shape, device=disp.device)
    warped = grid_sample(moving.float(), deform, max_disp=model.max_disp)
    lap("identity_clamp_warp")
    sim = sim_loss(warped.float(), fixed.float())
    lap("lncc_forward")
    reg = reg_loss(disp.float())
    lap("bending_forward")
    (sim + reg).backward()
    lap("backward")
    optimizer.step()
    lap("optimizer")
    return out


def run_reg_path(seed, workdir):
    import torch

    import train_reg_torch
    from deepatlas_torch.data import (Compose, CropVolume, VolumeToArray,
                                      get_reg_dataset)
    from deepatlas_torch.kernels import (grid_sample, launch_counts,
                                         reset_launch_counts)
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network
    from deepatlas_torch.ops import warp_values_adjoint
    from deepatlas_torch.train import (load_checkpoint, make_optimizer,
                                       registration)

    t0 = time.perf_counter()
    names = write_reg_corpus(workdir, seed)
    setup_s = time.perf_counter() - t0

    argv = ["--data-root", workdir, "--log-root", "logs", "--num-samples",
            "21", "--num-epochs", "1", "--max-validation-pairs", "2",
            "--device", "cuda"]
    rec = StepRecorder(lambda out: {k: float(v) for k, v in out[1].items()})
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(out), \
            mock.patch.object(registration, "make_reg_train_step",
                              rec.train_factory(
                                  registration.make_reg_train_step)), \
            mock.patch.object(registration, "make_reg_eval_step",
                              rec.eval_factory(
                                  registration.make_reg_eval_step)):
        dice_per_class, dice_avg, folding = train_reg_torch.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    # outside the main path's count, behind a reset of its own: the splat
    # through the entry point the joint training will use, on the trained
    # field of the first test pair; <warp(v), c> = <v, splat(c)> must hold
    run_dirs = [os.path.join(dp, "checkpoint")
                for dp, _, files in os.walk(os.path.join(workdir, "logs"))
                if "checkpoint" in files]
    mb = os.path.join(workdir, "mindboggle")
    dataset = get_reg_dataset("MindBoggle")(
        os.path.join(mb, "NKI-RS-21-train.txt"), mb, pre_transform=Compose(
            [VolumeToArray(), CropVolume(MB_CROP)]))
    sample_m, sample_f = dataset[0]
    moving = torch.from_numpy(np.ascontiguousarray(
        sample_m["image"])[None]).cuda()
    fixed = torch.from_numpy(np.ascontiguousarray(
        sample_f["image"])[None]).cuda()
    model = get_network("voxel_morph_cvpr")(max_disp=REG_MAX_DISP,
                                            dtype=torch.bfloat16)
    model.load_state_dict(load_checkpoint(run_dirs[0])["model"])
    model.cuda()
    with torch.no_grad():
        deform = model(moving, fixed)[2]

    def warp_fn(v, g):
        return grid_sample(v, g, max_disp=REG_MAX_DISP)

    ct = fixed.float()
    reset_launch_counts()
    lhs = (warp_fn(moving.float(), deform).double() * ct.double()).sum()
    splat = warp_values_adjoint(warp_fn, ct, deform)
    rhs = (moving.double() * splat.double()).sum()
    torch.cuda.synchronize()
    # the warp of the left side, then the adjoint's warp of its zero primal
    # followed by its splat
    adjoint_launches = {k: v for k, v in launch_counts().items() if v}
    adjoint_want = {"warp_trilinear": 2, "splat_trilinear": 1}
    adjoint_err = abs(lhs.item() - rhs.item()) / abs(lhs.item())

    n_eval = len(rec.eval_launches)
    want = {k: TRAIN_STEPS * REG_STEP_LAUNCHES[k]
            + n_eval * REG_EVAL_LAUNCHES[k] for k in REG_STEP_LAUNCHES}
    sims = [m["sim"] for m in rec.losses]
    warm = sorted(rec.seconds[2:])
    train_wall = rec.last_end - rec.first_start
    log({"phase": "reg", "volume_shape": MB_SHAPE,
         "train_shape": TRAIN_SHAPE, "max_disp": REG_MAX_DISP,
         "train_volumes": N_REG_TRAIN_VOLUMES, "steps": len(rec.losses),
         "evaluated_pairs": n_eval, "launches": counts,
         "launches_expected": want, "launches_per_step": REG_STEP_LAUNCHES,
         "launches_per_pair": REG_EVAL_LAUNCHES,
         "metrics": {k: [m[k] for m in rec.losses]
                     for k in ("loss", "sim", "reg", "disp_overflow")},
         "sim_first10_mean": float(np.mean(sims[:10])),
         "sim_last10_mean": float(np.mean(sims[-10:])),
         "first_steps_s": rec.seconds[:2],
         "step_s_median": warm[len(warm) // 2], "step_s_min": warm[0],
         "step_s_max": warm[-1],
         "pairs_per_s_in_steps": 1.0 / (sum(warm) / len(warm)),
         "pairs_per_s_with_loading": len(rec.losses) / train_wall,
         "setup_s": setup_s, "cli_s": total_s,
         "max_memory_allocated": peak, "test_dice_avg": float(dice_avg),
         "test_folding_fraction": float(folding),
         "adjoint_identity_rel_err": adjoint_err,
         "adjoint_identity_rel_tol": ADJOINT_TOL,
         "adjoint_check_launches": adjoint_launches,
         "checkpoints": [os.path.relpath(d, workdir) for d in run_dirs],
         "cli_tail": out.getvalue().splitlines()[-6:]})
    if len(rec.losses) != TRAIN_STEPS or n_eval != 4:
        raise AssertionError(f"{len(rec.losses)} steps and {n_eval} "
                             f"evaluated pairs, expected {TRAIN_STEPS}, 4")
    for i, got in enumerate(rec.step_launches):
        if got != REG_STEP_LAUNCHES:
            raise AssertionError(f"step {i} launched {got}, expected "
                                 f"{REG_STEP_LAUNCHES}")
    for got in rec.eval_launches:
        if got != REG_EVAL_LAUNCHES:
            raise AssertionError(f"an evaluation launched {got}, expected "
                                 f"{REG_EVAL_LAUNCHES}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for m in rec.losses:
        if set(m) != {"loss", "sim", "reg", "disp_overflow"} \
                or not np.all(np.isfinite(list(m.values()))):
            raise AssertionError(f"bad step metrics {m}")
    if not np.mean(sims[-10:]) < np.mean(sims[:10]):
        raise AssertionError(f"the similarity loss did not fall: {sims}")
    if len(run_dirs) != 1:
        raise AssertionError(f"expected one checkpoint, found {run_dirs}")
    if dice_per_class.shape != (TRAIN_CLASSES - 1,) \
            or not np.all(np.isfinite(dice_per_class)) \
            or not np.isfinite(folding):
        raise AssertionError(f"bad test result {dice_per_class} {folding}")
    if adjoint_launches != adjoint_want:
        raise AssertionError(f"the adjoint check launched {adjoint_launches}"
                             f", expected {adjoint_want}")
    if not adjoint_err <= ADJOINT_TOL:
        raise AssertionError(f"<warp(v), c> = {lhs.item()} but "
                             f"<v, splat(c)> = {rhs.item()}")

    # one more step by hand on the trained state: where its time goes, and
    # its gradients through the kernels against the plain versions
    sim_loss = get_loss_function("lncc")(filter_size=9)
    reg_loss = get_loss_function("bendingEnergy")()
    optimizer = make_optimizer(model, 1e-3)
    reg_step_breakdown(model, sim_loss, reg_loss, optimizer, moving, fixed)
    split = reg_step_breakdown(model, sim_loss, reg_loss, optimizer, moving,
                               fixed)
    agree = {}
    for dtype in (torch.bfloat16, None):
        model.dtype = dtype
        dname = "bfloat16" if dtype else "float32"
        sim_k, reg_k, got = reg_step_gradients(model, sim_loss, reg_loss,
                                               moving, fixed)
        with plain_math():
            sim_p, reg_p, ref = reg_step_gradients(model, sim_loss, reg_loss,
                                                   moving, fixed)
        worst_max, worst_mean = (0.0, ""), (0.0, "")
        for name, r in ref.items():
            scale = r.abs().max().item()
            diff = (got[name] - r).abs()
            if not torch.isfinite(diff).all():
                raise AssertionError(f"non-finite gradient in {name}")
            worst_max = max(worst_max, (diff.max().item() / scale, name))
            worst_mean = max(worst_mean, (diff.mean().item() / scale, name))
        agree[dname] = {"sim_kernels": sim_k, "sim_plain": sim_p,
                        "reg_kernels": reg_k, "reg_plain": reg_p,
                        "worst_max_rel": worst_max,
                        "worst_mean_rel": worst_mean}
        if dtype is None:
            agree[dname]["rel_tol_max"] = REG_GRAD_TOL["float32"]
            bad = worst_max[0] > REG_GRAD_TOL["float32"]
        else:
            agree[dname]["rel_tol_mean"] = REG_GRAD_TOL["bfloat16_mean"]
            agree[dname]["rel_tol_max"] = REG_GRAD_TOL["bfloat16_max"]
            bad = worst_mean[0] > REG_GRAD_TOL["bfloat16_mean"] \
                or worst_max[0] > REG_GRAD_TOL["bfloat16_max"]
        agree[dname]["ok"] = not (bad or abs(sim_k - sim_p)
                                  > NET_TOL[dname])
    log({"phase": "reg_check", "step_split_s": split,
         "gradients_vs_plain": agree, "pair": names[-2:]})
    if not all(a["ok"] for a in agree.values()):
        raise AssertionError(f"step gradients disagree: {agree}")
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "deepatlas_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from deepatlas_torch.kernels import build

    # every float32 reference in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    log({"phase": "device", "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    seconds = build.build()
    ptxas = [ln.strip() for log_text in build.build_logs.values()
             for ln in log_text.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "per_source_s": seconds, "ptxas": ptxas})

    with torch.no_grad():
        summary = check_kernels(args.seed)
        check_upsample(args.seed)
    check_warp_kernels(summary, args.seed)

    launches = {}
    for path, run in (("serving", run_main_path), ("training", run_train_path),
                      ("registration", run_reg_path)):
        with tempfile.TemporaryDirectory() as workdir:
            launches[path] = run(args.seed, workdir)

    kernels = []
    times = ("ms", "plain_ms", "bound_ms", "library_ms")
    for name, s in summary.items():
        src, replaces = KERNEL_INFO[name]
        flops = sum(s[path]["flops"] for path in PATHS)
        nbytes = sum(s[path]["bytes"] for path in PATHS)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": sum(launches[path][name] for path in PATHS),
                 "max_abs_err": s["max_abs_err"]}
        for key in times:
            entry[key] = sum(s[path][key] for path in PATHS)
        entry["bound_by"] = "operations" \
            if flops / PEAK_FLOPS["bfloat16"] >= nbytes / HBM_BYTES_PER_S \
            else "bytes"
        for path in PATHS:
            entry[path] = dict({k: s[path][k] for k in times},
                               launches=launches[path][name])
        on_a_path = any(per[name] for per in (
            STEP_LAUNCHES, EVAL_LAUNCHES, REG_STEP_LAUNCHES,
            REG_EVAL_LAUNCHES))
        if on_a_path and entry["launches"] == 0:
            raise AssertionError(f"no main path launched {name}")
        if not on_a_path:
            # held against its plain version above and launched by the
            # adjoint check, but a kernel of no main path yet
            entry["on_a_main_path"] = False
        kernels.append(entry)
    print(nvidia_smi(), flush=True)
    log({"kernels": kernels,
         "note": "ms, plain_ms, library_ms and bound_ms are totals over one "
                 "tile batch (4 x 128^3) of the serving path, one training "
                 "step of UNet_light (168x200x168, 32 classes) and one "
                 "registration step of VoxelMorph (168x200x168), split "
                 "under 'serving', 'training' and 'registration': bfloat16 "
                 "for the convolutions, float32 with one channel on the "
                 "smooth field for the warp kernels, one call each; "
                 "launches are the three main paths' runs, read when each "
                 "CLI returns (no main path launches the splat yet: it is "
                 "the warp's gradient in the moving image, which the "
                 "registration step does not ask for; it is held against "
                 "its plain version in the kernels phase and launched by "
                 "the adjoint identity check, counted apart under the reg "
                 "phase's adjoint_check_launches); max_abs_err is the largest over every shape "
                 "and type; library_ms of warp_grid_grad and of "
                 "splat_trilinear is the same F.grid_sample backward call, "
                 "which computes both"})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
