#!/usr/bin/env python3
"""Smoke run of deepatlas_torch on one CUDA card: the quickest proof that
the PyTorch port builds, is right and runs its main path on the GPU.

Phases (one JSON line each, any failure exits nonzero before the last line):

  1. device  -- card name, ``nvidia-smi`` name and power limit; TF32 off for
     every float32 reference.
  2. build   -- compile the CUDA sources of deepatlas_torch/kernels/csrc
     (the ``ptxas`` report of every kernel logged, and per source the most
     registers a kernel uses and its spill bytes).
  3. kernels -- each kernel against its plain PyTorch version at every
     shape the four main paths launch it at, in float32 and bfloat16, with
     kernel / plain / library (cuDNN) times from CUDA events and the least
     time the card could take (``bound_ms``), and the kernel's and the
     library call's queued (device) times.  The k3 conv and its weight
     gradient run on the tensor cores in bfloat16 (``csrc/conv3d_mma.cu``)
     and on the CUDA cores in float32 (``csrc/conv3d.cu``,
     ``csrc/conv3d_wgrad.cu``), the transposed conv and the 1x1x1 conv on
     the tensor cores in bfloat16 (``csrc/channel_mix_mma.cu``) and on the
     CUDA cores in float32 (``csrc/deconv3d.cu``, ``csrc/conv3d.cu``);
     every weight gradient, transposed conv and 1x1x1 conv is computed
     twice and the two must be equal bit for bit.  Serving: the UNet_light tile
     forward (batch 4 of 128^3 tiles).  Training: one step on a 168x200x168
     volume with 32 classes -- the forward convs, kernel A again at its 13
     input-gradient shapes (Cin and Cout swapped), the head's kernel at its
     input-gradient shape, and the k3 weight-gradient kernel at its 14
     shapes.  Registration: one VoxelMorph step on a 168x200x168 pair --
     kernel A at its 11 forward (4 of them strided) and 10 input-gradient
     (4 strided: the parity-class launch in bfloat16, the stride-1 kernel
     on the zero-stuffed gradient in float32) shapes and the
     weight-gradient kernel at its 11 (4 strided), the
     transposed-conv kernel at the decoder's full-resolution upsample (also
     with the identity bank against ``nearest_resize``), and the three warp
     kernels (trilinear warp, its grid
     gradient, the splat) at 1x168x200x168 with one channel (the step's
     call) and two, in float32 and bfloat16, on a smooth field (up to 2.5
     voxels) and on a saturated one (up to 20 voxels, clamped to 8), and at
     two odd small shapes (3 and 33 channels); the splat, which adds in
     64-bit fixed point, twice and bit for bit; then the differentiable
     entry point's two gradients against the same Function on the plain
     versions.  Joint: the warp and splat again at the anatomy's 32
     channels (bfloat16 probabilities and float32, both fields; the float32
     one-hot the f-hard branch splats), and the
     matched-label kernels (the matched warp, its fused derivative planes,
     its grid cotangent) at 1x168x200x168 with 32 block labels on the
     smooth and the saturated field and at one odd small shape, each run
     twice and required bit-identical, with ``F.grid_sample`` of the
     32-channel one-hot as the library yardstick; then the anatomy dice's
     deformation gradient three ways (fused, value kernel + grid cotangent,
     plain versions), counted apart from the main paths.  Block conv: the
     multi-plane k3 forward (kernel K, on no model path) against its plain
     version and against the k3 conv kernel at UNet_light's 13 forward k3
     shapes at 168x200x168, at p_blk 2, 4 and 8 in both types, and at one
     odd small shape whose depths are no multiple of p_blk.
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
     <warp(v), c> = <v, splat(c)> must hold (the registration step does not
     launch the splat: the moving image is data).  One step's gradients
     through the kernels must agree with the same step on the plain
     versions.
  7. joint   -- the joint DeepAtlas path: the registration corpus (4
     training and 2 validation volumes, at 0.1 of full intensity so that
     most of the joint recipe's untrained field is not past the clamp:
     ``JOINT_INTENSITY``) and ``train_deepatlas_torch.main
     --num-samples 21 --num-epochs 1 --n-labeled 2 --max-validation-pairs
     2``: 42 iterations at the recipe's full width (UNet_light with 32
     classes and VoxelMorph, both bf16; the seg phase on even iterations,
     the reg phase on odd ones), one validation, a joint checkpoint and
     ``test()``.  With 2 of 4 volumes labelled every seg regime (soft,
     f-hard, m-hard, hard) and the reg step's label substitution must run;
     each step's launches must equal the table of its regime
     (``joint_seg_launches``, ``joint_reg_launches``), read when the CLI
     returns; every metric must be finite, the reg phase's similarity must
     fall (last 5 steps against the first 5) and the test Dice and folding
     must be finite.  Then, on two states (the CLI's seeded draw of both
     nets in float32 and its trained checkpoint in bf16), one seg step per
     regime (twice through the kernels, the two compared bit for bit:
     ``rerun_*``) and one reg step with
     and without substitution, through the kernels against the plain versions: the
     parameter gradients within ``JOINT_GRAD_TOL``, the step's metrics
     within ``STEP_METRIC_TOL``; on the trained state each step is
     profiled.  The seeded draw's untrained field is also measured on the
     first pair at the corpus's intensity and at three times it.
  8. convs   -- the conv tools: ``tools/bench_packed_conv_torch.py
     --before-after`` (the per-shape roofline of kernels A, B and C on
     UNet_light's forward at 168x200x168, then A, D, C and B in bf16 per
     shape on the tensor cores, on the CUDA cores and in cuDNN, in turns) and
     ``tools/bench_block_conv_torch.py`` (kernel K at p_blk
     2, 4 and 8 against kernel A, cuDNN beside), ``--iters 3`` each, with
     their rows logged; each kernel must launch exactly as often as the
     tool called it, K's launches are the ones its kernels entry counts
     apart.  Run after the kernels phase, before the main paths.

Then the ``nvidia-smi`` line, the kernels summary line and, last,
``{"ok": true, "device": {...}}``.  Run with no arguments:
``python3 chip_smoke.py``.
"""
import argparse
import contextlib
import functools
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
# (the main paths' bfloat16 one where the type picks the kernel)
KERNEL_INFO = {
    "conv3d_k3": ("deepatlas_torch/kernels/csrc/conv3d_mma.cu",
                  "deepatlas_tpu/pallas/conv3d.py:170"),
    "deconv2x": ("deepatlas_torch/kernels/csrc/channel_mix_mma.cu",
                 "deepatlas_tpu/pallas/deconv3d.py:55"),
    "conv3d_point": ("deepatlas_torch/kernels/csrc/channel_mix_mma.cu",
                     "deepatlas_tpu/pallas/conv3d.py:215"),
    "conv3d_k3_wgrad": ("deepatlas_torch/kernels/csrc/conv3d_mma.cu",
                        "deepatlas_tpu/pallas/conv3d.py:359"),
    "warp_trilinear": ("deepatlas_torch/kernels/csrc/warp.cu",
                       "deepatlas_tpu/pallas/warp.py:329"),
    "warp_grid_grad": ("deepatlas_torch/kernels/csrc/warp.cu",
                       "deepatlas_tpu/pallas/warp.py:415"),
    "splat_trilinear": ("deepatlas_torch/kernels/csrc/warp.cu",
                        "deepatlas_tpu/pallas/splat.py:106"),
    "matched_warp_fused": ("deepatlas_torch/kernels/csrc/anatomy.cu",
                           "deepatlas_tpu/pallas/anatomy.py:116"),
    "matched_warp": ("deepatlas_torch/kernels/csrc/anatomy.cu",
                     "deepatlas_tpu/pallas/anatomy.py:46"),
    "matched_grid_grad": ("deepatlas_torch/kernels/csrc/anatomy.cu",
                          "deepatlas_tpu/pallas/anatomy.py:213"),
    "conv3d_k3_block": ("deepatlas_torch/kernels/csrc/conv3d_block.cu",
                        "deepatlas_tpu/pallas/conv3d.py:273"),
}
# the kernels whose source the tensor's type picks: the tensor cores in
# bfloat16 (every main path), the CUDA cores in float32
SOURCES_BY_DTYPE = {
    "conv3d_k3": {"bfloat16": "deepatlas_torch/kernels/csrc/conv3d_mma.cu",
                  "float32": "deepatlas_torch/kernels/csrc/conv3d.cu"},
    "conv3d_k3_wgrad": {
        "bfloat16": "deepatlas_torch/kernels/csrc/conv3d_mma.cu",
        "float32": "deepatlas_torch/kernels/csrc/conv3d_wgrad.cu"},
    "deconv2x": {
        "bfloat16": "deepatlas_torch/kernels/csrc/channel_mix_mma.cu",
        "float32": "deepatlas_torch/kernels/csrc/deconv3d.cu"},
    "conv3d_point": {
        "bfloat16": "deepatlas_torch/kernels/csrc/channel_mix_mma.cu",
        "float32": "deepatlas_torch/kernels/csrc/conv3d.cu"},
}
# kernels whose reruns must be equal bit for bit: no atomics, or (the
# splat) integer atomics, whose sums do not depend on their order
DETERMINISTIC = ("conv3d_k3_wgrad", "deconv2x", "conv3d_point",
                 "splat_trilinear")
PATHS = ("serving", "training", "registration", "joint")

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
# the values' type; the splat sums the plain version's float32 products in
# 64-bit fixed point (exact to 2^-38 of a channel's largest cotangent a
# term at 5.6 M points) and rounds once, the plain version adds them in
# float32, a few dozen a voxel.
WARP_TOL = {"warp_trilinear": {"float32": 1e-5, "bfloat16": 1e-2},
            "warp_grid_grad": {"float32": 1e-4, "bfloat16": 1e-4},
            "splat_trilinear": {"float32": 1e-5, "bfloat16": 1e-5}}
# the matched-label kernels against their plain versions: m lies in [0, 1]
# and both sides add the same 8 exact products w_k * {0, 1} in corner
# order, so it is held absolutely; the derivative planes (and J's cotangent)
# are the weight derivatives added in another order than autograd's and
# scaled by (n - 1) / 2 up to 99.5: relative to their largest entry
MATCHED_TOL = {"m": 1e-6, "planes": 1e-5}
# the anatomy dice through the kernels against the plain versions: the same
# per-class sums (float32 index_add_, atomics in any order over 5.6 M
# voxels) and the same per-point gradients
ANATOMY_LOSS_TOL = 1e-5
ANATOMY_GRAD_TOL = 1e-4
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
# one joint step's parameter gradients through the kernels against the plain
# versions, per tensor relative to its largest entry, on two states: the
# CLI's seeded draw in float32 (nets and anatomy) and its trained checkpoint
# in bfloat16, as the CLI runs.  The seg step is held in the mean over a
# tensor's entries, the reg step in the mean and at the worst entry; each
# limit is 4-10 times the largest reading of runs on an H100 (in PERF.md),
# where a zeroed tensor reads about 0.1 in the mean and 1 at the worst
# entry.  Readings: bfloat16 seg 1.2e-2, reg 1.3e-3 and 9.0e-3; float32 seg
# 4.3e-3, reg 1.9e-6 and 2.4e-5.  The seeded draw's seg net has BatchNorm
# gradients that are sums over 5.6 M voxels which nearly cancel: summation
# order alone moves them that far in float32, and one bf16 rounding flipped
# by 6-10% of their largest entry, so the draw is held in float32.
JOINT_GRAD_TOL = {
    "float32": {"seg_mean": 2e-2, "reg_mean": 2e-5, "reg_max": 2e-4},
    "bfloat16": {"seg_mean": 5e-2, "reg_mean": 1e-2, "reg_max": 5e-2}}
# the same steps' metrics (loss, anatomy and supervised dice, similarity,
# smoothness, overflow share), kernels against plain versions, held
# absolutely: 3.0e-5 at worst on both states (PERF.md)
STEP_METRIC_TOL = 2e-4
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
NO_LAUNCHES = dict.fromkeys(KERNEL_INFO, 0)
STEP_LAUNCHES = dict(NO_LAUNCHES, conv3d_k3=27, deconv2x=3, conv3d_point=2,
                     conv3d_k3_wgrad=14)
EVAL_LAUNCHES = dict(NO_LAUNCHES, conv3d_k3=14, deconv2x=3, conv3d_point=1)

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
REG_STEP_LAUNCHES = dict(NO_LAUNCHES, conv3d_k3=21, deconv2x=1,
                         conv3d_k3_wgrad=11, warp_trilinear=1,
                         warp_grid_grad=1)
REG_EVAL_LAUNCHES = dict(NO_LAUNCHES, conv3d_k3=11, deconv2x=1,
                         warp_trilinear=1)

# the joint recipe of train_deepatlas_torch.py: 2 of the 4 training volumes
# labelled, so the 12 ordered pairs hold 2 hard, 4 m-hard, 4 f-hard and 2
# soft ones
JOINT_N_LABELED = 2
JOINT_ITERATIONS = 42
# the joint corpus's intensity scale (write_reg_corpus): the joint recipe
# draws its VoxelMorph from the seeded generator after its UNet_light, and
# that draw's untrained field, proportional to its input, is past the
# 8-voxel clamp on the first training pair at 99.5% of the voxels on
# 0.3-scale images, where the clamp passes almost no gradient, and at 55.9%
# at 0.1, from where the reg phase brings it inside within a few steps
# (joint_check's untrained_disp_overflow, measured on an H100)
JOINT_INTENSITY = 0.1
REGIMES = ("soft", "f_hard", "m_hard", "hard")


def add_launches(*tables):
    out = dict(NO_LAUNCHES)
    for table in tables:
        for k, v in table.items():
            out[k] += v
    return out


# the frozen reg net's deformation in a seg step: VoxelMorph's forward
# convs and its upsample, no warp (the seg phase warps anatomies only)
REG_FORWARD_LAUNCHES = dict(NO_LAUNCHES, conv3d_k3=11, deconv2x=1)
# the anatomy of a seg step by branch (hard_fused): soft warps the moving
# probabilities (C = 32) and splats their gradient; f_hard splats the fixed
# one-hot (C = 32) and warps nothing; m_hard warps the moving one-hot once,
# as a constant; hard takes the matched-label warp and a C = 1 splat of
# ones.  Without hard_fused every step takes the soft branch.
SEG_ANATOMY_LAUNCHES = {
    "soft": {"warp_trilinear": 1, "splat_trilinear": 1},
    "f_hard": {"splat_trilinear": 1},
    "m_hard": {"warp_trilinear": 1},
    "hard": {"matched_warp": 1, "splat_trilinear": 1}}
# the reg step's anatomy: fused, the matched warp with its planes, the splat
# of ones and that splat's backward on the grid-gradient kernel; dense (past
# the guard's last rung), the C = 32 one-hot warp and its grid gradient
REG_ANATOMY_LAUNCHES = {
    True: {"matched_warp_fused": 1, "splat_trilinear": 1,
           "warp_grid_grad": 1},
    False: {"warp_trilinear": 1, "warp_grid_grad": 1}}


def joint_seg_launches(regime, hard_fused=True):
    """A joint seg step's launches: the frozen reg net's forward, two
    UNet_light training passes (moving, then fixed) and the anatomy."""
    return add_launches(REG_FORWARD_LAUNCHES, STEP_LAUNCHES, STEP_LAUNCHES,
                        SEG_ANATOMY_LAUNCHES[regime if hard_fused else
                                             "soft"])


def joint_reg_launches(substituted, fused_anatomy=True):
    """A joint reg step's launches: one UNet_light eval forward per side
    whose labels are replaced by the frozen seg net's prediction, the
    VoxelMorph training step and the anatomy."""
    return add_launches(*[EVAL_LAUNCHES] * substituted, REG_STEP_LAUNCHES,
                        REG_ANATOMY_LAUNCHES[fused_anatomy])


def log(obj):
    print(json.dumps(obj), flush=True)


def ptxas_summary(text):
    """The most registers a kernel of one source uses, and its spill bytes
    (stores + loads), from ``ptxas -v``'s report."""
    import re

    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spill_bytes": sum(spills)}


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
    (role ``dx_s2``) reads the ``ceil(n / 2)`` gradient and writes the
    input's resolution, one launch of ``conv3d_k3_input_grad`` (in bfloat16
    over the 8 parity classes, 1/8 of the stride-1 operations; in float32
    the stride-1 kernel on a zero-stuffed gradient), and is bounded by what
    the function needs: the gradient read once and 1/8 of the stride-1
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


# the kernels that check_kernels times at every shape of the paths, with
# their queued times (device_ms, library_device_ms) beside the event times
KERNEL_SHAPES = ("conv3d_k3", "deconv2x", "conv3d_point", "conv3d_k3_wgrad")
DEVICE_TIMES = ("device_ms", "library_device_ms")
# the kernels whose bfloat16 calls took the CUDA-core kernel of
# csrc/channel_mix.cuh before the tensor-core one: that kernel, through its
# C entry point, is timed beside it at every shape
CUDA_CORE_TWINS = ("deconv2x", "conv3d_point")
CUDA_CORE_TIMES = ("cuda_core_ms", "cuda_core_device_ms")
# the warp kernels, timed by check_warp_kernels with their queued times too
WARP_KERNELS = ("warp_trilinear", "warp_grid_grad", "splat_trilinear")


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


# the spin that holds the stream while the host enqueues a queued timing's
# calls: ~28 ms at the H100's 1.755 GHz boost clock, far above the host's
# ~0.1-0.2 ms per wrapper call
QUEUE_CYCLES = 50_000_000


def cuda_ms(fn, reps, warmup=1, queued=False):
    """ms per call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup``.  Where the host takes longer to issue a call than the card
    to run it (small shapes), this time is the host's.  With ``queued`` a
    spin kernel (``torch.cuda._sleep``) first holds the stream while the
    host enqueues all the calls, so the events time the card's work alone:
    the device time of the call."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_call(kernel, x, w, stride=1, dhw=None):
    """One PyTorch (cuDNN) call computing the same function: the yardstick
    for ``library_ms`` only; the port never calls it.  For the weight
    gradient ``w`` is the upstream gradient; with ``dhw`` (the input's
    size) the k3 conv's call is its input gradient, ``x`` the upstream
    gradient and ``w`` the conv's weights."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)           # NDHWC storage, NCDHW view
    if dhw is not None:
        wk = w.to(x.dtype).permute(4, 3, 0, 1, 2)
        size = (x.shape[0], w.shape[-2]) + tuple(dhw)
        return lambda: torch.nn.grad.conv3d_input(size, wk, xc,
                                                  stride=stride, padding=1)
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


def unit_counts(path, role, per_unit):
    """The units a conv case's launches count in: its own path's, and the
    joint unit's (one reg step without label substitution and one seg step
    in each of the four label regimes): every seg step runs two UNet_light
    training passes and the frozen VoxelMorph's forward, the reg step one
    VoxelMorph training step."""
    yield path, per_unit
    if path == "training":
        yield "joint", 2 * len(REGIMES) * per_unit
    elif path == "registration":
        frozen = len(REGIMES) if role in ("forward", "forward_s2") else 0
        yield "joint", (1 + frozen) * per_unit


def check_kernels(seed):
    """Phase 3, convolutions: each against its plain version at every shape
    of the three paths in both types.  Returns ``{kernel: {"max_abs_err",
    path: {ms, plain_ms, library_ms, bound_ms, flops, bytes, device_ms,
    library_device_ms, cuda_core_ms, cuda_core_device_ms}}}`` with the
    bfloat16 totals of one unit of each path (a tile batch; a training
    step); the warp kernels' entries are filled by ``check_warp_kernels``.
    ``device_ms`` and ``library_device_ms`` are the kernel's and the
    library call's queued times (``cuda_ms(queued=True)``): the card's work
    without the host's launch overhead, which the event times of the
    smaller shapes hold; ``cuda_core_*`` the same for the CUDA-core kernel
    of ``CUDA_CORE_TWINS``.  The kernels of ``DETERMINISTIC`` run twice
    and must give the same bits."""
    import torch

    from deepatlas_torch.kernels import (KERNELS, conv3d,
                                         conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain, deconv3d)
    from deepatlas_torch.kernels.conv3d import kernel_operands

    simt_of = {"deconv2x": deconv3d._deconv_simt,
               "conv3d_point": conv3d._point_simt}

    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "flops", "bytes",
            *DEVICE_TIMES, *CUDA_CORE_TIMES)
    summary = {name: dict({path: dict.fromkeys(keys, 0.0) for path in PATHS},
                          max_abs_err=0.0)
               for name in KERNELS}
    for (path, name, role, batch, size, cin, cout), per_unit in \
            all_cases().items():
        fn, plain = KERNELS[name]
        n = batch * int(np.prod(size))
        big = n * max(cin, cout) > 2e8      # fewer repeats on the largest
        stride = 2 if role.endswith("_s2") else 1
        kw = {"stride": 2} if stride == 2 else {}
        out_size = tuple(-(-v // stride) for v in size)
        n_out = batch * int(np.prod(out_size))
        in_size = size
        if role == "dx_s2":
            # the strided conv's input gradient: the upstream gradient
            # (cin channels at ceil(n / 2)) to the input (cout channels)
            fn, plain = conv3d_k3_input_grad, conv3d_k3_input_grad_plain
            kw = {"dhw": size, "stride": 2}
            in_size = out_size
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = (torch.rand((batch,) + in_size + (cin,), generator=gen,
                            device="cuda") * 2 - 1).to(dtype)
            if role == "dx_s2":
                second = torch.randn((3, 3, 3, cout, cin), generator=gen,
                                     device="cuda") / np.sqrt(27 * cout)
                args = timed_args = (x, second)
            elif name == "conv3d_k3_wgrad":
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
            # no atomics (the weight gradient's fixed-order sums, the
            # channel mix's per-voxel sums): the same bits again
            repeatable = None
            if name in DETERMINISTIC:
                repeatable = bool(torch.equal(got, fn(*args, **kw)))
                ok = ok and repeatable
            del got, ref
            ms = cuda_ms(lambda: fn(*timed_args, **kw), reps=3 if big else 5)
            plain_ms = cuda_ms(lambda: plain(*timed_args, **kw),
                               reps=1 if big else 2, warmup=0 if big else 1)
            lib = library_call(name, x, second, stride,
                               size if role == "dx_s2" else None)
            lib_ms = cuda_ms(lib, reps=3 if big else 5)
            dev_ms = cuda_ms(lambda: fn(*timed_args, **kw),
                             reps=3 if big else 5, queued=True)
            lib_dev_ms = cuda_ms(lib, reps=3 if big else 5, queued=True)
            # the bfloat16 channel mix's earlier kernel, on the CUDA cores
            # through its C entry point, on the same inputs
            simt = simt_ms = simt_dev_ms = None
            if name in CUDA_CORE_TWINS and dname == "bfloat16":
                simt = functools.partial(simt_of[name], x,
                                         kernel_operands(x, second, None)[0],
                                         None)
                simt_ms = cuda_ms(simt, reps=5)
                simt_dev_ms = cuda_ms(simt, reps=5, queued=True)
            bms, bound_by = bound_ms(name, n, cin, cout, dname, n_out, role)
            log({"phase": "kernels", "path": path, "kernel": name,
                 "role": role, "dtype": dname, "x": list(x.shape),
                 "cin": cin, "cout": cout, "launches_per_unit": per_unit,
                 "source": SOURCES_BY_DTYPE.get(name, {}).get(dname),
                 "max_abs_err": err, "max_abs_ref": scale,
                 "rel_tol": tol, "bit_identical_rerun": repeatable,
                 "ok": ok, "kernel_ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "kernel_device_ms": dev_ms, "library_device_ms": lib_dev_ms,
                 "cuda_core_ms": simt_ms, "cuda_core_device_ms": simt_dev_ms,
                 "bound_ms": bms, "bound_by": bound_by})
            if not ok:
                raise AssertionError(f"{name} {role} {dname} "
                                     f"{tuple(x.shape)} -> {cout}: max|k-p| "
                                     f"{err} (limit {tol} * {scale}), "
                                     f"bit-identical rerun {repeatable}")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
            if dname == "bfloat16":       # the main paths' type, per unit
                flops, nbytes = work(name, n, cin, cout, dname, n_out, role)
                for upath, times in unit_counts(path, role, per_unit):
                    tot = summary[name][upath]
                    for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                     ("library_ms", lib_ms),
                                     ("bound_ms", bms), ("flops", flops),
                                     ("bytes", nbytes),
                                     ("device_ms", dev_ms),
                                     ("library_device_ms", lib_dev_ms),
                                     ("cuda_core_ms", simt_ms or 0.0),
                                     ("cuda_core_device_ms",
                                      simt_dev_ms or 0.0)):
                        tot[key] += times * val
            del x, second, args, timed_args, lib, simt
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
    gradient and writes its float32 volume (here as many points as the
    grid's) once."""
    if kernel == "warp_trilinear":
        return n * (12 + 2 * elem * c)
    if kernel == "warp_grid_grad":
        return n * (12 + 2 * elem * c + 12)
    return n * (12 + elem * c + 4 * c)


# the joint unit's warp-kernel calls by (channels, type): the reg step's
# image warp, its grid gradient and the splat of ones with that splat's
# backward (float32, C = 1); the soft and m-hard seg steps' C = 32 warp, the
# soft step's C = 32 splat of its bfloat16 probability gradient, the f-hard
# step's C = 32 splat of the float32 one-hot, the hard step's splat of ones
JOINT_WARP_UNIT = {
    "warp_trilinear": {(1, "float32"): 1, (TRAIN_CLASSES, "bfloat16"): 2},
    "warp_grid_grad": {(1, "float32"): 2},
    "splat_trilinear": {(1, "float32"): 2, (TRAIN_CLASSES, "bfloat16"): 1,
                        (TRAIN_CLASSES, "float32"): 1}}


def check_warp_kernels(summary, seed):
    """Phase 3, warp kernels: E, F and G against their plain versions, with
    kernel / plain / library (``F.grid_sample``, timed on float32 values:
    it wants the grid in the values' type, and a bfloat16 grid cannot
    address 168 voxels) times.  Its one backward call computes both the
    grid gradient and the splat, so that time stands beside each of them.
    The cases: 1, 2 and 32 channels (the registration step's image warp
    and the splat of ones; the joint training's anatomy warps and splats)
    in float32 and bfloat16 on the smooth and the saturated field, the
    f-hard branch's float32 one-hot splat, and two odd small shapes.  The
    splat (``DETERMINISTIC``) runs twice and must give the same bits.
    Kernel times by events and queued (``device_ms``).  Fills ``summary``'s
    registration unit with the float32 one-channel smooth-field case and
    its joint unit with the calls of one reg step and one seg step per
    label regime (``JOINT_WARP_UNIT``; the f-hard splat by the random
    float32 cotangent, as earlier slices timed it; a line of its own gives
    the unit with the f-hard branch's one-hot in its place).
    """
    import torch
    import torch.nn.functional as F

    from deepatlas_torch import kernels
    from deepatlas_torch.ops import clamp_displacement

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    full = (1,) + TRAIN_SHAPE
    # (field, shape, channels, type, amplitude, one-hot values and upstream
    # gradient): C = 1, 2 and 32 in both types on both fields, the f-hard
    # branch's float32 one-hot splat, two odd small shapes
    cases = [(field, full, c, dtype, amp, False)
             for c in (1, 2, TRAIN_CLASSES)
             for dtype in (torch.float32, torch.bfloat16)
             for field, amp in (("smooth", 2.5), ("saturated", 20.0))]
    cases += [("smooth", full, TRAIN_CLASSES, torch.float32, 2.5, True),
              ("odd", (2, 13, 17, 11), 3, torch.float32, 3.0, False),
              ("odd", (2, 9, 10, 13), 33, torch.bfloat16, 3.0, False)]
    per_call = {}
    for field, shape, c, dtype, amp, onehot in cases:
        dname = str(dtype).split(".")[1]
        big = shape == full
        grid = clamp_displacement(smooth_grid(shape, amp, seed),
                                  REG_MAX_DISP).contiguous()
        if onehot:
            labels = block_labels(shape, shift=(3, 5, 7))
            vol = ct = torch.nn.functional.one_hot(
                labels.long(), c).to(dtype).contiguous()
        else:
            vol = torch.rand(shape + (c,), generator=gen,
                             device="cuda").to(dtype)
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
            # the fixed-point splat: the same bits again
            repeatable = None
            if name in DETERMINISTIC:
                repeatable = bool(torch.equal(got, fn()))
                ok = ok and repeatable
            del got, ref
            ms = cuda_ms(fn, reps=5)
            dev_ms = cuda_ms(fn, reps=5, queued=True)
            plain_ms = cuda_ms(plain, reps=2 if big else 3)
            lib_ms = cuda_ms(library, reps=5)
            nbytes = warp_bytes(name, n, c, 2 if dname == "bfloat16" else 4)
            bms = nbytes / HBM_BYTES_PER_S * 1e3
            log({"phase": "kernels", "kernel": name, "path":
                 "joint" if c == TRAIN_CLASSES else "registration",
                 "field": field, "dtype": dname, "vol": list(vol.shape),
                 "one_hot": onehot,
                 "max_disp": REG_MAX_DISP, "max_abs_err": err,
                 "max_abs_ref": scale, "rel_tol": tol,
                 "bit_identical_rerun": repeatable, "ok": ok,
                 "kernel_ms": ms, "kernel_device_ms": dev_ms,
                 "plain_ms": plain_ms,
                 "library_ms": lib_ms, "library": "F.grid_sample forward"
                 if name == "warp_trilinear" else
                 "F.grid_sample backward (grid gradient and splat in one)",
                 "bound_ms": bms, "bound_by": "bytes"})
            if not ok:
                raise AssertionError(f"{name} {field} {dname} {shape} C={c}: "
                                     f"max|k-p| {err} > {tol} * {scale}, "
                                     f"bit-identical rerun {repeatable}")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
            # the main paths' calls on the smooth field
            if big and field == "smooth":
                per_call[(name, c, dname, onehot)] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, flops=0.0, bytes=float(nbytes),
                    device_ms=dev_ms)
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
        log({"phase": "kernels", "kernel": "grid_sample (entry point)",
             "path": "joint" if c == TRAIN_CLASSES else "registration",
             "field": field,
             "dtype": dname, "vol": list(vol.shape), "gradients": errs,
             "points_without_grid_gradient": saturated})
        if not all(e["ok"] for e in errs.values()):
            raise AssertionError(f"grid_sample gradients {field} {dname}: "
                                 f"{errs}")
        del grads, vol, ct, grid, raw
        torch.cuda.empty_cache()
    for name in WARP_KERNELS:
        summary[name]["registration"].update(
            per_call[(name, 1, "float32", False)])
        for key, times in JOINT_WARP_UNIT[name].items():
            for k, v in per_call[(name,) + key + (False,)].items():
                summary[name]["joint"][k] += times * v
    # the same joint unit of G with the f-hard branch's float32 one-hot,
    # whose zero cotangents the kernel skips, in place of the random one
    key = ("splat_trilinear", TRAIN_CLASSES, "float32")
    log({"phase": "kernels", "kernel": "splat_trilinear",
         "joint_unit_with_f_hard_one_hot": {
             k: summary[key[0]]["joint"][k] - per_call[key + (False,)][k]
             + per_call[key + (True,)][k]
             for k in ("ms", "device_ms", "plain_ms", "library_ms",
                       "bound_ms")}})


def block_labels(shape, shift=(0, 0, 0)):
    """``(B, D, H, W)`` int32 labels 0..31 on the card: a 4 x 4 x 2 grid of
    blocks, as the synthetic corpora label their volumes, moved by
    ``shift`` voxels."""
    import torch

    b, d, h, w = shape
    idx = [((torch.arange(n, device="cuda") + sh) * blocks // n).clamp(
        0, blocks - 1) for n, sh, blocks in zip((d, h, w), shift, (4, 4, 2))]
    lab = (idx[0][:, None, None] * 4 + idx[1][None, :, None]) * 2 \
        + idx[2][None, None, :]
    return lab.expand(b, d, h, w).to(torch.int32).contiguous()


def matched_bytes(name, n):
    """Bytes the function must move on ``n`` sample points: 12 of
    coordinates, 4 of ``lab_f`` and 4 of ``lab_m`` read per point; H writes
    ``m`` (4), I ``m`` and three planes (16), J reads ``ct`` (4) and writes
    three planes (12)."""
    return n * {"matched_warp": 24, "matched_warp_fused": 36,
                "matched_grid_grad": 36}[name]


def check_anatomy_kernels(summary, seed):
    """Phase 3, the matched-label kernels H, I and J against their plain
    versions at 1x168x200x168 with 32 block labels, on a smooth field (up to
    2.5 voxels) and a saturated one (up to 20 voxels, clamped to 8), and at
    one odd small shape with random labels; each launched twice and
    required bit-identical; J equal bit for bit to ``ct`` times I's planes.
    Times: kernel, plain version, library (``F.grid_sample`` of the C = 32
    float32 one-hot: its forward for H, forward and grid backward for I and
    J) and the byte bound.  Then ``hard_anatomy_dice``'s deformation
    gradient three ways: through I (fused), through H and J, and on the
    plain versions.  Fills ``summary``'s joint unit: H once (the hard seg
    step), I once (the reg step); J, on no main path, per call."""
    import torch
    import torch.nn.functional as F

    from deepatlas_torch import kernels
    from deepatlas_torch.kernels import launch_counts
    from deepatlas_torch.ops import clamp_displacement, one_hot

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    full = (1,) + TRAIN_SHAPE
    apart = {}
    for field, shape, amp in (("smooth", full, 2.5), ("saturated", full, 20.0),
                              ("odd", (2, 13, 17, 11), 3.0)):
        big = shape == full
        raw = smooth_grid(shape, amp, seed)
        grid = clamp_displacement(raw, REG_MAX_DISP).contiguous()
        if big:
            lab_f, lab_m = block_labels(shape), block_labels(shape, (2, -3, 1))
        else:
            lab_f, lab_m = (torch.randint(0, TRAIN_CLASSES, shape,
                                          generator=gen, device="cuda",
                                          dtype=torch.int32)
                            for _ in range(2))
        ct = torch.rand(shape, generator=gen, device="cuda") * 2 - 1
        n = int(np.prod(shape))
        onehot_l = one_hot(lab_m.long(), TRAIN_CLASSES).permute(
            0, 4, 1, 2, 3).contiguous()
        grid_l = grid.clone().requires_grad_(True)
        ct_l = torch.rand(onehot_l.shape, generator=gen, device="cuda")

        def library_fwd():
            return F.grid_sample(onehot_l, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)

        def library_fwd_bwd():
            out = F.grid_sample(onehot_l, grid_l, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            return torch.autograd.grad(out, grid_l, ct_l)

        args = (lab_m, lab_f, grid)
        calls = {
            "matched_warp": (lambda: kernels.matched_warp(*args),
                             lambda: kernels.matched_warp_plain(*args),
                             library_fwd),
            "matched_warp_fused": (
                lambda: kernels.matched_warp_fused(*args),
                lambda: kernels.matched_warp_fused_plain(*args),
                library_fwd_bwd),
            "matched_grid_grad": (
                lambda: kernels.matched_grid_grad(*args, ct),
                lambda: kernels.matched_grid_grad_plain(*args, ct),
                library_fwd_bwd)}
        before = launch_counts()
        for name, (fn, plain, library) in calls.items():
            got, again, ref = fn(), fn(), plain()
            torch.cuda.synchronize()
            if not isinstance(got, tuple):
                got, again, ref = (got,), (again,), (ref,)
            identical = all(torch.equal(a, b) for a, b in zip(got, again))
            errs = []
            for a, b in zip(got, ref):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise AssertionError(f"{name} {shape}: kernel gives "
                                         f"{tuple(a.shape)} {a.dtype}, plain "
                                         f"{tuple(b.shape)} {b.dtype}")
                err = (a - b).abs().max().item()
                # m: an absolute bound; planes: relative to the largest
                scale = 1.0 if b.dim() == 4 else b.abs().max().item()
                tol = MATCHED_TOL["m" if b.dim() == 4 else "planes"]
                errs.append({"max_abs_err": err, "scale": scale,
                             "tol": tol * scale,
                             "ok": bool(np.isfinite(err)) and err <= tol
                             * scale})
            del got, again, ref
            ms = cuda_ms(fn, reps=5)
            plain_ms = cuda_ms(plain, reps=2 if big else 3)
            lib_ms = cuda_ms(library, reps=3)
            bms = matched_bytes(name, n) / HBM_BYTES_PER_S * 1e3
            log({"phase": "kernels", "path": "joint", "kernel": name,
                 "field": field, "labels": list(lab_m.shape),
                 "classes": TRAIN_CLASSES, "max_disp": REG_MAX_DISP,
                 "outputs_vs_plain": errs, "bit_identical_rerun": identical,
                 "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                 "library": "F.grid_sample forward, C=32 float32 one-hot"
                 + ("" if name == "matched_warp" else " + grid backward"),
                 "bound_ms": bms, "bound_by": "bytes"})
            if not identical or not all(e["ok"] for e in errs):
                raise AssertionError(f"{name} {field} {shape}: {errs}, "
                                     f"bit-identical rerun {identical}")
            summary[name]["max_abs_err"] = max(
                summary[name]["max_abs_err"],
                max(e["max_abs_err"] for e in errs))
            if big and field == "smooth":
                summary[name]["joint"].update(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bms, flops=0.0,
                    bytes=float(matched_bytes(name, n)))
        # J is ct times I's planes, bit for bit
        _, planes = kernels.matched_warp_fused(*args)
        if not torch.equal(kernels.matched_grid_grad(*args, ct),
                           ct[..., None] * planes):
            raise AssertionError(f"matched_grid_grad {field}: not ct * the "
                                 f"fused planes")
        del planes, onehot_l, grid_l, ct_l

        # the anatomy dice's deformation gradient three ways
        vals, grads, launched = {}, {}, {}
        for way in ("fused", "matched_grid_grad", "plain"):
            g = raw.clone().requires_grad_(True)
            start = launch_counts()
            with plain_math() if way == "plain" else contextlib.nullcontext():
                loss = kernels.hard_anatomy_dice(
                    lab_m, lab_f, g, TRAIN_CLASSES, max_disp=REG_MAX_DISP,
                    fused_grad=way != "matched_grid_grad")
                loss.backward()
            torch.cuda.synchronize()
            vals[way], grads[way] = loss.item(), g.grad
            end = launch_counts()
            launched[way] = {k: end[k] - start[k] for k in end
                             if end[k] != start[k]}
        want = {"fused": {"matched_warp_fused": 1, "splat_trilinear": 1,
                          "warp_grid_grad": 1},
                "matched_grid_grad": {"matched_warp": 1, "splat_trilinear": 1,
                                      "matched_grid_grad": 1,
                                      "warp_grid_grad": 1},
                "plain": {}}
        scale = grads["plain"].abs().max().item()
        agree = {way: {"loss": vals[way], "loss_abs_err":
                       abs(vals[way] - vals["plain"]),
                       "grad_max_abs_err":
                       (grads[way] - grads["plain"]).abs().max().item(),
                       "launches": launched[way]}
                 for way in ("fused", "matched_grid_grad")}
        log({"phase": "kernels", "path": "joint",
             "kernel": "hard_anatomy_dice (deformation gradient)",
             "field": field, "labels": list(lab_m.shape),
             "loss_plain": vals["plain"], "grad_max_abs_ref": scale,
             "loss_tol": ANATOMY_LOSS_TOL,
             "grad_rel_tol": ANATOMY_GRAD_TOL, "ways": agree,
             "points_without_gradient":
                 (grads["fused"] == 0).all(dim=-1).float().mean().item()})
        for way, a in agree.items():
            if a["launches"] != want[way] or launched["plain"] \
                    or not a["loss_abs_err"] <= ANATOMY_LOSS_TOL \
                    or not a["grad_max_abs_err"] <= ANATOMY_GRAD_TOL * scale:
                raise AssertionError(f"hard_anatomy_dice {field} {way}: {a}")
        end = launch_counts()
        for k in end:
            apart[k] = apart.get(k, 0) + end[k] - before[k]
        del grads, raw, grid, lab_m, lab_f, ct
        torch.cuda.empty_cache()

    # the anatomy dice's per-class sums (index_add_, not a kernel): spread
    # over lanes, as binned_sum adds them, against one address per class
    from deepatlas_torch.kernels.anatomy import _BIN_LANES, binned_sum
    lab = block_labels(full).long()
    vals = torch.rand(lab.shape, generator=gen, device="cuda")

    def one_lane():
        return torch.zeros(TRAIN_CLASSES, device="cuda").index_add_(
            0, lab.reshape(-1), vals.reshape(-1))

    ref = one_lane()
    err = ((binned_sum(vals, lab, TRAIN_CLASSES) - ref).abs().max()
           / ref.abs().max()).item()
    log({"phase": "kernels", "path": "joint",
         "kernel": "binned_sum (index_add_, not a kernel)",
         "labels": list(lab.shape), "classes": TRAIN_CLASSES,
         "lanes": _BIN_LANES,
         "ms": cuda_ms(lambda: binned_sum(vals, lab, TRAIN_CLASSES), reps=5),
         "one_lane_ms": cuda_ms(one_lane, reps=5),
         "rel_err_vs_one_lane": err})
    # float32 sums of 176 k values in [0, 1) per class, in any order
    if not err <= 1e-4:
        raise AssertionError(f"binned_sum against one lane: {err}")
    return apart


# kernel K at the block-conv microbench's p_blk values on UNet_light's
# forward shapes; the odd shape's depths are no multiple of the p_blk values
# beside them (the tail block)
BLOCK_P_BLKS = (2, 4, 8)
BLOCK_DEFAULT_P_BLK = 4          # conv3d_k3_block's default
BLOCK_TAIL = {"hw": (13, 37), "cin": 24, "cout": 40, "depths": (7, 10, 12),
              "p_blks": (2, 3, 4)}
# the convs phase runs each tool with this many timed launches per shape
CONV_TOOL_ITERS = 3


def forward_k3_shapes():
    """``{(dhw, cin, cout): calls per forward}`` of UNet_light's k3 convs
    on one 168x200x168 volume: 13 shapes, 14 calls."""
    return {(size, cin, cout): n for (_, kernel, _, _, size, cin, cout), n
            in unet_cases("training", 1, TRAIN_SHAPE, TRAIN_CLASSES,
                          False).items() if kernel == "conv3d_k3"}


def check_block_kernel(seed):
    """Phase 3, kernel K (``conv3d_k3_block``): against its plain version
    and against kernel A (the same function) at every k3 shape of
    UNet_light's forward at 168x200x168, at p_blk 2, 4 and 8, in float32
    and bfloat16, under A's limits (``TOL``); then at one odd small shape
    whose depths 7, 10 and 12 are no multiple of the p_blk values 2, 3 and 4.
    The plain version is timed in bfloat16 at the forward's shapes (K's own
    times come from the convs phase).  Returns ``{"max_abs_err",
    "max_abs_diff_vs_a", "plain_ms": {(dhw, cin, cout): ms}}``."""
    import torch

    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_block,
                                         conv3d_k3_block_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    cases = [((1,) + size, cin, cout, BLOCK_P_BLKS, n)
             for (size, cin, cout), n in forward_k3_shapes().items()]
    cases += [((1, d) + BLOCK_TAIL["hw"], BLOCK_TAIL["cin"],
               BLOCK_TAIL["cout"], BLOCK_TAIL["p_blks"], 0)
              for d in BLOCK_TAIL["depths"]]
    out = {"max_abs_err": 0.0, "max_abs_diff_vs_a": 0.0, "plain_ms": {}}
    for shape, cin, cout, p_blks, n in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = (torch.rand(shape + (cin,), generator=gen, device="cuda") * 2
                 - 1).to(dtype)
            w = torch.randn((3, 3, 3, cin, cout), generator=gen,
                            device="cuda") / np.sqrt(27 * cin)
            ref = conv3d_k3_block_plain(x, w).float()
            a = conv3d_k3(x, w).float()
            scale = ref.abs().max().item()
            errs, diffs = {}, {}
            for p in p_blks:
                got = conv3d_k3_block(x, w, p_blk=p)
                torch.cuda.synchronize()
                if got.shape != shape + (cout,) or got.dtype != dtype:
                    raise AssertionError(
                        f"conv3d_k3_block p_blk={p} {shape}: gives "
                        f"{tuple(got.shape)} {got.dtype}")
                got = got.float()
                errs[p] = (got - ref).abs().max().item()
                diffs[p] = (got - a).abs().max().item()
                del got
            limit = TOL[dname] * scale
            ok = all(np.isfinite(e) and e <= limit
                     for e in (*errs.values(), *diffs.values()))
            rec = {"phase": "kernels", "path": "block_conv",
                   "kernel": "conv3d_k3_block", "dtype": dname,
                   "x": list(x.shape), "cin": cin, "cout": cout,
                   "calls_per_forward": n, "max_abs_err_vs_plain": errs,
                   "max_abs_diff_vs_conv3d_k3": diffs,
                   "max_abs_ref": scale, "rel_tol": TOL[dname], "ok": ok}
            if dname == "bfloat16" and n:
                rec["plain_ms"] = out["plain_ms"][(shape[1:], cin, cout)] = \
                    cuda_ms(lambda: conv3d_k3_block_plain(x, w), reps=1,
                            warmup=0)
            log(rec)
            if not ok:
                raise AssertionError(
                    f"conv3d_k3_block {dname} {tuple(x.shape)} -> {cout}: "
                    f"vs plain {errs}, vs conv3d_k3 {diffs}, limit {limit}")
            out["max_abs_err"] = max(out["max_abs_err"], *errs.values())
            out["max_abs_diff_vs_a"] = max(out["max_abs_diff_vs_a"],
                                           *diffs.values())
            del x, w, ref, a
    torch.cuda.empty_cache()
    return out


def run_conv_tools():
    """Phase 8 (convs): ``tools/bench_packed_conv_torch.py`` (the per-shape
    roofline of kernels A, B, C on UNet_light's forward) and
    ``tools/bench_block_conv_torch.py`` (K at p_blk 2, 4 and 8 against A,
    with cuDNN's time beside) with ``--iters 3``, each with the launch
    counts set to 0 just before it and read just after: every kernel must
    have launched exactly as often as the tool called its wrapper, and the
    tools' census must agree with ``forward_k3_shapes``.  Returns each
    tool's result and launches."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_block_conv_torch
    import bench_packed_conv_torch

    from deepatlas_torch.kernels import launch_counts, reset_launch_counts

    results = {}
    for name, tool, extra in (
            ("roofline", bench_packed_conv_torch, ["--before-after"]),
            ("block", bench_block_conv_torch, [])):
        t0 = time.perf_counter()
        table = io.StringIO()
        reset_launch_counts()
        with contextlib.redirect_stdout(table):
            res = tool.main(["--iters", str(CONV_TOOL_ITERS), *extra])
        counts = launch_counts()
        seconds = time.perf_counter() - t0
        want = dict(NO_LAUNCHES, **res["calls"])
        log({"phase": "convs", "tool": tool.__name__ + ".py",
             "iters": CONV_TOOL_ITERS, "seconds": seconds,
             "table": table.getvalue().splitlines(), "rows": res["rows"],
             "before_after": res.get("before_after"), "calls": res["calls"],
             "launches": {k: v for k, v in counts.items() if v}})
        if counts != want:
            raise AssertionError(f"{tool.__name__}: launches {counts}, "
                                 f"wrapper calls {res['calls']}")
        results[name] = dict(res, launches=counts)
    census = {(tuple(r["x"][1:4]), r["cin"], r["cout"]): r["n"]
              for r in results["block"]["rows"]}
    if census != forward_k3_shapes():
        raise AssertionError(f"the tools' census {census} differs from "
                             f"UNet_light's plan {forward_k3_shapes()}")
    return results


def block_entry(block, convs):
    """The ``kernels`` line's entry for K: totals over the 14 forward convs
    at the wrapper's default p_blk (and per p_blk, per shape), the plain
    version and cuDNN on the same calls, the bound; on no main path, its
    launches are the block-conv microbench's."""
    src, replaces = KERNEL_INFO["conv3d_k3_block"]
    rows, totals = convs["block"]["rows"], convs["block"]["totals"]
    flops = nbytes = bound = 0.0
    for (size, cin, cout), n in forward_k3_shapes().items():
        f, b = work("conv3d_k3", int(np.prod(size)), cin, cout, "bfloat16")
        flops, nbytes = flops + n * f, nbytes + n * b
        bound += n * bound_ms("conv3d_k3", int(np.prod(size)), cin, cout,
                              "bfloat16")[0]
    return {
        "name": "conv3d_k3_block", "route": "cuda", "source": src,
        "replaces": replaces, "launches": 0,
        "max_abs_err": block["max_abs_err"],
        "ms": totals["k_ms"][BLOCK_DEFAULT_P_BLK],
        "plain_ms": sum(n * block["plain_ms"][key]
                        for key, n in forward_k3_shapes().items()),
        "bound_ms": bound,
        "bound_by": "operations" if flops / PEAK_FLOPS["bfloat16"]
        >= nbytes / HBM_BYTES_PER_S else "bytes",
        "library_ms": totals["library_ms"],
        "on_a_main_path": False,
        "launches_outside_main_paths":
            convs["block"]["launches"]["conv3d_k3_block"],
        "max_abs_diff_vs_conv3d_k3": block["max_abs_diff_vs_a"],
        "conv3d_k3_ms": totals["a_ms"],
        "p_blk": {str(p): {"ms": totals["k_ms"][p],
                           "per_shape_ms": [
                               {"x": r["x"], "cin": r["cin"],
                                "cout": r["cout"], "calls_per_forward": r["n"],
                                "ms": r["k_ms"][p]} for r in rows]}
                  for p in BLOCK_P_BLKS}}


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
    from deepatlas_torch.kernels import anatomy, conv3d, deconv3d, warp

    with mock.patch.object(conv3d, "_k3_cuda", conv3d._k3_math), \
            mock.patch.object(conv3d, "_dx_cuda", conv3d._dx_math), \
            mock.patch.object(conv3d, "_wgrad_cuda", conv3d._wgrad_math), \
            mock.patch.object(conv3d, "_point_cuda", conv3d._point_math), \
            mock.patch.object(deconv3d, "_deconv_cuda",
                              deconv3d._deconv_math), \
            mock.patch.object(warp, "_warp_cuda", warp._warp_math), \
            mock.patch.object(warp, "_grid_grad_cuda",
                              warp._grid_grad_math), \
            mock.patch.object(warp, "_splat_cuda", warp._splat_math), \
            mock.patch.object(anatomy, "_matched_cuda",
                              anatomy._matched_math), \
            mock.patch.object(anatomy, "_fused_cuda", anatomy._fused_math), \
            mock.patch.object(anatomy, "_grid_grad_cuda",
                              anatomy._grid_grad_math):
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
    learn to.  Intensities are ``intensity`` of full scale (mean: half of
    it): an untrained VoxelMorph has no bias yet, so its field is
    proportional to its input, and on full-scale images it starts far past
    the 8-voxel clamp at every voxel, where the clamp passes no gradient and
    the similarity cannot move (measured on an H100: ``disp_overflow`` 1.0
    and a constant similarity over all 42 steps at ``intensity=1``).  The
    first 4 volumes train; the last 2 validate and test (two volumes make
    two ordered pairs)."""
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


class JointRecorder:
    """Wraps the joint experiment's step factories to record, per step, its
    phase, label flags, metrics, seconds (synchronised), peak memory, the
    kernels it launched and the launches its branch should make; per
    evaluated volume or pair, its launches."""

    def __init__(self):
        self.steps, self.evals = [], []
        self.first_start = self.last_end = None

    def step_factory(self, make, phase):
        import torch

        from deepatlas_torch.kernels import launch_counts

        def factory(*args, **kwargs):
            step = make(*args, **kwargs)
            fused = kwargs.get("fused_anatomy", False)
            hard_fused = kwargs.get("hard_fused", False)

            def recorded(state, other, *tensors):
                am, af = bool(tensors[4].all()), bool(tensors[5].all())
                before = launch_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if self.first_start is None:
                    self.first_start = t0
                out = step(state, other, *tensors)
                torch.cuda.synchronize()
                self.last_end = time.perf_counter()
                after = launch_counts()
                rec = {"phase": phase, "seconds": self.last_end - t0,
                       "peak": torch.cuda.max_memory_allocated(),
                       "metrics": {k: float(v) for k, v in out[1].items()},
                       "launches": {k: after[k] - before[k] for k in after}}
                if phase == "seg":
                    rec["regime"] = REGIMES[am * 2 + af]
                    rec["expected"] = joint_seg_launches(rec["regime"],
                                                         hard_fused)
                else:
                    rec["substituted"] = (not am) + (not af)
                    rec["expected"] = joint_reg_launches(rec["substituted"],
                                                         fused)
                self.steps.append(rec)
                return out

            return recorded

        return factory

    def eval_factory(self, make, phase):
        from deepatlas_torch.kernels import launch_counts

        def factory(n_class):
            step = make(n_class)

            def recorded(state, *tensors):
                before = launch_counts()
                out = step(state, *tensors)
                after = launch_counts()
                self.evals.append((phase, {k: after[k] - before[k]
                                           for k in after}))
                return out

            return recorded

        return factory


def grad_agreement(got, ref, skip=()):
    """The worst tensor's largest and mean difference, each relative to
    that tensor's largest reference entry: ``((max_rel, name), (mean_rel,
    name))``."""
    import torch

    worst_max, worst_mean = (0.0, ""), (0.0, "")
    for name, r in ref.items():
        if name in skip:
            continue
        scale = r.abs().max().item()
        diff = (got[name] - r).abs()
        if not torch.isfinite(diff).all():
            raise AssertionError(f"non-finite gradient in {name}")
        worst_max = max(worst_max, (diff.max().item() / scale, name))
        worst_mean = max(worst_mean, (diff.mean().item() / scale, name))
    return worst_max, worst_mean


def step_gradients_of(step, state, other, tensors):
    """Metrics and parameter gradients of one joint step on a state whose
    optimizer does not move (SGD at learning rate 0); BatchNorm statistics
    are put back, so repeated calls start from the same state."""
    import torch

    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, metrics = step(state, other, *tensors)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().float().clone()
             for n, p in state.model.named_parameters()}
    state.model.load_state_dict(saved)
    state.optimizer.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in metrics.items()}, grads


def profiled(fn, reps=2):
    """One call of ``fn`` under ``torch.profiler`` after ``reps`` warm ones:
    host-clock ms, device-busy ms, the idle share, the most memory allocated
    during the call and the kernels by device time (the 8 largest)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0))

    rows = sorted(((device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"host_ms": host_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / host_ms)
            if busy_ms else None, "peak_allocated_gb": peak_gb,
            "kernels": [{"name": key[:80], "ms": us / 1e3, "launches": n}
                        for us, n, key in rows[:8]]}


def run_joint_path(seed, workdir):
    import torch

    import train_deepatlas_torch
    from deepatlas_torch.data import (Compose, CropVolume, VolumeToArray,
                                      get_reg_dataset)
    from deepatlas_torch.kernels import (grid_sample, launch_counts,
                                         reset_launch_counts)
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network
    from deepatlas_torch.ops import displacement_overflow
    from deepatlas_torch.train import (TrainState, deepatlas,
                                       load_checkpoint, make_joint_reg_step,
                                       make_joint_seg_step)

    t0 = time.perf_counter()
    write_reg_corpus(workdir, seed, intensity=JOINT_INTENSITY)
    setup_s = time.perf_counter() - t0

    argv = ["--data-root", workdir, "--log-root", "logs", "--num-samples",
            "21", "--num-epochs", "1", "--n-labeled", str(JOINT_N_LABELED),
            "--max-validation-pairs", "2", "--device", "cuda"]
    rec = JointRecorder()
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(out), \
            mock.patch.object(deepatlas, "make_joint_seg_step",
                              rec.step_factory(deepatlas.make_joint_seg_step,
                                               "seg")), \
            mock.patch.object(deepatlas, "make_joint_reg_step",
                              rec.step_factory(deepatlas.make_joint_reg_step,
                                               "reg")), \
            mock.patch.object(deepatlas, "make_seg_eval_step",
                              rec.eval_factory(deepatlas.make_seg_eval_step,
                                               "seg")), \
            mock.patch.object(deepatlas, "make_reg_eval_step",
                              rec.eval_factory(deepatlas.make_reg_eval_step,
                                               "reg")):
        seg_pc, seg_dice, reg_pc, reg_dice, folding = \
            train_deepatlas_torch.main(argv)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = launch_counts()

    seg_steps = [r for r in rec.steps if r["phase"] == "seg"]
    reg_steps = [r for r in rec.steps if r["phase"] == "reg"]
    want = add_launches(*[r["expected"] for r in rec.steps],
                        *[EVAL_LAUNCHES if phase == "seg" else
                          REG_EVAL_LAUNCHES for phase, _ in rec.evals])
    regimes = {name: sum(r["regime"] == name for r in seg_steps)
               for name in REGIMES}
    substituted = [r["substituted"] for r in reg_steps]
    sims = [r["metrics"]["sim"] for r in reg_steps]
    cli_lines = out.getvalue().splitlines()
    guard = [ln for ln in cli_lines if "disp_overflow" in ln]
    run_dirs = [os.path.join(dp, "checkpoint")
                for dp, _, files in os.walk(os.path.join(workdir, "logs"))
                if "checkpoint" in files]

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    warm = rec.steps[2:]
    log({"phase": "joint", "volume_shape": MB_SHAPE,
         "train_shape": TRAIN_SHAPE, "n_classes": TRAIN_CLASSES,
         "n_labeled": JOINT_N_LABELED, "iterations": len(rec.steps),
         "seg_steps_by_regime": regimes,
         "reg_steps_by_substituted_sides": {
             k: substituted.count(k) for k in (0, 1, 2)},
         "launches": counts, "launches_expected": want,
         "launches_per_seg_step": {r: joint_seg_launches(r)
                                   for r in REGIMES},
         "launches_per_reg_step": {k: joint_reg_launches(k)
                                   for k in (0, 1, 2)},
         "evaluations": [phase for phase, _ in rec.evals],
         "seg_metrics": {k: [r["metrics"][k] for r in seg_steps]
                         for k in ("loss", "anatomy", "supervised")},
         # past the guard's last rung the warp is unclamped and a reg step
         # reports no disp_overflow (None here)
         "reg_metrics": {k: [r["metrics"].get(k) for r in reg_steps]
                         for k in ("loss", "sim", "reg", "anatomy",
                                   "disp_overflow")},
         "reg_steps_fused_anatomy": [r["expected"]["matched_warp_fused"] == 1
                                     for r in reg_steps],
         "reg_sim_first5_mean": float(np.mean(sims[:5])),
         "reg_sim_last5_mean": float(np.mean(sims[-5:])),
         "guard_lines": guard,
         "first_steps_s": [r["seconds"] for r in rec.steps[:2]],
         "seg_step_s_median": median([r["seconds"] for r in warm
                                      if r["phase"] == "seg"]),
         "seg_step_s_median_by_regime": {
             name: median([r["seconds"] for r in warm
                           if r.get("regime") == name]) for name in REGIMES},
         "reg_step_s_median": median([r["seconds"] for r in warm
                                      if r["phase"] == "reg"]),
         "reg_step_s_median_by_substituted_sides": {
             k: median([r["seconds"] for r in warm
                        if r.get("substituted") == k]) for k in (0, 1, 2)},
         "pairs_per_s_in_steps":
             len(warm) / sum(r["seconds"] for r in warm),
         "pairs_per_s_with_loading":
             len(rec.steps) / (rec.last_end - rec.first_start),
         "peak_memory_by_regime": {
             name: max([r["peak"] for r in seg_steps
                        if r["regime"] == name], default=None)
             for name in REGIMES},
         "peak_memory_reg_step": max(r["peak"] for r in reg_steps),
         "peak_memory_per_step": [(r.get("regime") or r["phase"], r["peak"])
                                  for r in rec.steps],
         "setup_s": setup_s, "cli_s": total_s,
         "test_seg_dice_avg": float(seg_dice),
         "test_reg_dice_avg": float(reg_dice),
         "test_folding_fraction": float(folding),
         "checkpoints": [os.path.relpath(d, workdir) for d in run_dirs],
         "cli_tail": cli_lines[-4:]})
    if len(seg_steps) != JOINT_ITERATIONS // 2 \
            or len(reg_steps) != JOINT_ITERATIONS // 2 \
            or [p for p, _ in rec.evals].count("seg") != 4 \
            or [p for p, _ in rec.evals].count("reg") != 4:
        raise AssertionError(f"{len(seg_steps)} seg and {len(reg_steps)} "
                             f"reg steps, evaluations {rec.evals}")
    if not all(regimes.values()) or not any(substituted):
        raise AssertionError(f"a branch did not run: seg regimes {regimes}, "
                             f"reg substitutions {substituted}")
    # the matched-label kernels on every step that should take them: the
    # guard's last rung (the unclamped warp) would turn them off
    if any(r["launches"]["matched_warp_fused"] != 1 for r in reg_steps) \
            or any(r["launches"]["matched_warp"] != 1 for r in seg_steps
                   if r["regime"] == "hard"):
        raise AssertionError(f"a reg step without the fused matched warp or "
                             f"a hard seg step without the matched warp: "
                             f"guard {guard}")
    for i, r in enumerate(rec.steps):
        if r["launches"] != r["expected"]:
            raise AssertionError(f"iteration {i} ({r['phase']}) launched "
                                 f"{r['launches']}, expected "
                                 f"{r['expected']}")
    for phase, got in rec.evals:
        expected = EVAL_LAUNCHES if phase == "seg" else REG_EVAL_LAUNCHES
        if got != expected:
            raise AssertionError(f"a {phase} evaluation launched {got}, "
                                 f"expected {expected}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    for r in rec.steps:
        if not np.all(np.isfinite(list(r["metrics"].values()))):
            raise AssertionError(f"non-finite metrics {r}")
    if not np.mean(sims[-5:]) < np.mean(sims[:5]):
        raise AssertionError(f"the reg-phase similarity did not fall: {sims}")
    if not (np.all(np.isfinite(seg_pc)) and np.all(np.isfinite(reg_pc))
            and np.isfinite(folding) and seg_pc.shape == reg_pc.shape
            == (TRAIN_CLASSES - 1,)):
        raise AssertionError(f"bad test result {seg_pc} {reg_pc} {folding}")
    if len(run_dirs) != 1:
        raise AssertionError(f"expected one checkpoint, found {run_dirs}")

    # one joint step of each kind by hand, through the kernels and on the
    # plain versions (gradients only: the optimizers do not move and
    # BatchNorm's statistics are put back), on two states: the nets as the
    # CLI's seeded draw makes them, and the trained nets of its checkpoint
    config = train_deepatlas_torch.build_config(
        train_deepatlas_torch.parse_args(argv))
    with contextlib.redirect_stdout(io.StringIO()):
        exp = deepatlas.DeepAtlasExperiment(config)
    exp.setup_random_seed()
    exp.setup_model()
    def make_seg(dtype):
        return get_network("UNet_light")(
            in_channel=1, n_classes=TRAIN_CLASSES, bias=True, BN=True,
            dtype=dtype).cuda()

    def make_reg(dtype):
        return get_network("voxel_morph_cvpr")(
            max_disp=REG_MAX_DISP, dtype=dtype).cuda()

    def loaded(model, state):
        model.load_state_dict(state)
        return model

    ckpt = load_checkpoint(run_dirs[0], map_location="cuda")
    trained = [loaded(make_seg(torch.bfloat16), ckpt["seg_model"]),
               loaded(make_reg(torch.bfloat16), ckpt["reg_model"])]
    initial = [loaded(make_seg(torch.float32), exp.seg_model.state_dict()),
               loaded(make_reg(torch.float32), exp.reg_model.state_dict())]
    mb = os.path.join(workdir, "mindboggle")
    sample_m, sample_f = get_reg_dataset("MindBoggle")(
        os.path.join(mb, "MMRR-21-flip.txt"), mb, pre_transform=Compose(
            [VolumeToArray(), CropVolume(MB_CROP)]))[0]
    images = [torch.from_numpy(np.ascontiguousarray(s["image"])[None]).cuda()
              for s in (sample_m, sample_f)]
    labels = [torch.from_numpy(np.ascontiguousarray(
        s["segmentation"])[None]).cuda().long() for s in (sample_m, sample_f)]

    # the seeded draw's untrained field on this pair: the share of voxels
    # past the clamp at the corpus's intensity and at three times it (the
    # registration corpus's 0.3; the images are linear in the intensity)
    with torch.no_grad():
        untrained_overflow = {
            f"x{k}": float(displacement_overflow(exp.reg_model.cuda(
            ).deformation(images[0] * k, images[1] * k)[1], REG_MAX_DISP))
            for k in (1, 3)}

    def tensors(am, af):
        return (*images, *labels, torch.tensor([am]), torch.tensor([af]))

    def joint_steps(dtype):
        seg_step = make_joint_seg_step(
            get_loss_function("dice")(n_class=TRAIN_CLASSES,
                                      weight_type="Uniform", no_bg=False,
                                      softmax=True, eps=1e-6),
            3.0, 1.0, TRAIN_CLASSES, warp_fn=functools.partial(
                grid_sample, max_disp=REG_MAX_DISP, grad="values"),
            anatomy_dtype=dtype, hard_fused=True, max_disp=REG_MAX_DISP)
        reg_step = make_joint_reg_step(
            get_loss_function("lncc")(filter_size=9),
            get_loss_function("bendingEnergy")(), 1.0, 3.0, TRAIN_CLASSES,
            warp_fn=functools.partial(grid_sample, max_disp=REG_MAX_DISP),
            anatomy_dtype=dtype, max_disp=REG_MAX_DISP, fused_anatomy=True)
        return seg_step, reg_step

    def agreement(kind, dtype, g_k, g_p, skip=()):
        """The check's readings, its limits and whether they hold: the seg
        step in the mean, the reg step in the mean and at the worst
        entry."""
        worst_max, worst_mean = grad_agreement(g_k, g_p, skip)
        tol = JOINT_GRAD_TOL[str(dtype).split(".")[-1]]
        limits = {"mean": tol[f"{kind}_mean"]}
        if kind == "reg":
            limits["max"] = tol["reg_max"]
        readings = {"max": worst_max, "mean": worst_mean}
        return {"worst_max_rel": worst_max, "worst_mean_rel": worst_mean,
                "rel_tol": limits,
                "grads_ok": all(readings[k][0] <= v
                                for k, v in limits.items())}

    def metric_errors(m_k, m_p):
        errs = {k: abs(m_k[k] - m_p[k]) for k in m_k}
        return {"metrics_kernels": m_k, "metrics_plain": m_p,
                "metrics_abs_err": errs, "metric_tol": STEP_METRIC_TOL,
                "metrics_ok": max(errs.values()) <= STEP_METRIC_TOL}

    checks, splits = {}, {}
    for state_name, (seg_model, reg_model), dtype in (
            ("initial_float32", initial, torch.float32),
            ("trained_bfloat16", trained, torch.bfloat16)):
        seg_step, reg_step = joint_steps(dtype)
        seg_state = TrainState(seg_model, torch.optim.SGD(
            seg_model.parameters(), lr=0.0))
        reg_state = TrainState(reg_model, torch.optim.SGD(
            reg_model.parameters(), lr=0.0))
        # a conv or deconv bias in front of a BatchNorm: noise only
        skip = {f"{name}.bias" for name, mod in seg_model.named_modules()
                if getattr(mod, "bn", None) is not None}
        profile = dtype == torch.bfloat16
        for name in REGIMES:
            am = bool(REGIMES.index(name) // 2)
            af = bool(REGIMES.index(name) % 2)
            args = tensors(am, af)
            m_k, g_k = step_gradients_of(seg_step, seg_state, reg_state, args)
            _, g_k2 = step_gradients_of(seg_step, seg_state, reg_state, args)
            with plain_math():
                m_p, g_p = step_gradients_of(seg_step, seg_state, reg_state,
                                             args)
            rerun_max, rerun_mean = grad_agreement(g_k2, g_k, skip)
            checks[f"{state_name}_seg_{name}"] = dict(
                metric_errors(m_k, m_p),
                **agreement("seg", dtype, g_k, g_p, skip),
                rerun_worst_max_rel=rerun_max,
                rerun_worst_mean_rel=rerun_mean)
            if profile:
                splits[f"seg_{name}"] = profiled(lambda: step_gradients_of(
                    seg_step, seg_state, reg_state, args))
            del g_k, g_k2, g_p
        for substituted in (0, 1):
            args = tensors(True, not substituted)
            m_k, g_k = step_gradients_of(reg_step, reg_state, seg_state, args)
            with plain_math():
                m_p, g_p = step_gradients_of(reg_step, reg_state, seg_state,
                                             args)
            checks[f"{state_name}_reg_substituted_{substituted}"] = dict(
                metric_errors(m_k, m_p), **agreement("reg", dtype, g_k, g_p))
            if profile:
                splits[f"reg_substituted_{substituted}"] = profiled(
                    lambda: step_gradients_of(reg_step, reg_state, seg_state,
                                              args))
            del g_k, g_p
        del seg_state, reg_state, seg_model, reg_model
        torch.cuda.empty_cache()
    log({"phase": "joint_check", "gradients_vs_plain": checks,
         "states": "initial_float32: the CLI's seeded draw of both nets, "
                   "every tensor float32; trained_bfloat16: its "
                   "checkpoint, as the CLI runs",
         "untrained_disp_overflow": untrained_overflow,
         "rerun": "rerun_* : the same seg step twice through the "
                  "kernels, relative to each tensor's largest entry; G adds "
                  "in 64-bit fixed point and H, I, J have no atomics, so "
                  "0.0 unless another op of the step changes its bits "
                  "between runs",
         "step_split": splits})
    bad = [k for k, v in checks.items()
           if not (v["grads_ok"] and v["metrics_ok"])]
    if bad:
        raise AssertionError(f"joint steps disagree: "
                             f"{ {k: checks[k] for k in bad} }")
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
         "per_source_s": seconds, "ptxas": ptxas,
         "per_source": {name: ptxas_summary(text)
                        for name, text in build.build_logs.items()}})

    with torch.no_grad():
        summary = check_kernels(args.seed)
        check_upsample(args.seed)
        block = check_block_kernel(args.seed)
    check_warp_kernels(summary, args.seed)
    apart = check_anatomy_kernels(summary, args.seed)
    convs = run_conv_tools()

    launches = {}
    for path, run in (("serving", run_main_path), ("training", run_train_path),
                      ("registration", run_reg_path),
                      ("joint", run_joint_path)):
        with tempfile.TemporaryDirectory() as workdir:
            launches[path] = run(args.seed, workdir)

    step_tables = (STEP_LAUNCHES, EVAL_LAUNCHES, REG_STEP_LAUNCHES,
                   REG_EVAL_LAUNCHES, joint_reg_launches(0),
                   *[joint_seg_launches(r) for r in REGIMES])
    kernels = []
    times = ("ms", "plain_ms", "bound_ms", "library_ms")
    for name, s in summary.items():
        if name == "conv3d_k3_block":
            continue
        src, replaces = KERNEL_INFO[name]
        flops = sum(s[path]["flops"] for path in PATHS)
        nbytes = sum(s[path]["bytes"] for path in PATHS)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 **({"sources": SOURCES_BY_DTYPE[name]}
                    if name in SOURCES_BY_DTYPE else {}),
                 "launches": sum(launches[path][name] for path in PATHS),
                 "max_abs_err": s["max_abs_err"]}
        # the convolutions' queued (device) times beside the event times
        keys = times + (DEVICE_TIMES if name in KERNEL_SHAPES else ()) \
            + (("device_ms",) if name in WARP_KERNELS else ()) \
            + (CUDA_CORE_TIMES if name in CUDA_CORE_TWINS else ())
        for key in keys:
            entry[key] = sum(s[path][key] for path in PATHS)
        entry["bound_by"] = "operations" \
            if flops / PEAK_FLOPS["bfloat16"] >= nbytes / HBM_BYTES_PER_S \
            else "bytes"
        for path in PATHS:
            entry[path] = dict({k: s[path][k] for k in keys},
                               launches=launches[path][name])
        on_a_path = any(per[name] for per in step_tables)
        if on_a_path and entry["launches"] == 0:
            raise AssertionError(f"no main path launched {name}")
        if not on_a_path:
            # held against its plain version and launched by the anatomy
            # gradient check in the kernels phase, counted apart: the joint
            # training never differentiates the value-only matched warp
            entry["on_a_main_path"] = False
            entry["launches_outside_main_paths"] = apart[name]
        kernels.append(entry)
    kernels.append(block_entry(block, convs))
    print(nvidia_smi(), flush=True)
    log({"kernels": kernels,
         "note": "ms, plain_ms, library_ms and bound_ms are totals over one "
                 "unit of each main path, split under its name: one tile "
                 "batch (4 x 128^3) of the serving path, one training step "
                 "of UNet_light (168x200x168, 32 classes), one registration "
                 "step of VoxelMorph (168x200x168) and, for 'joint', one "
                 "reg step without label substitution plus four seg steps, "
                 "one in each label regime (soft, f_hard, m_hard, hard): "
                 "bfloat16 for the convolutions, the smooth field for the "
                 "warp and anatomy kernels (float32 with one channel for "
                 "the image warps and the splat of ones, 32 channels for "
                 "the anatomy warps and splats, random values: the f-hard "
                 "splat's one-hot stands in the kernels phase's line "
                 "joint_unit_with_f_hard_one_hot); matched_grid_grad, which "
                 "no main path launches, gives its time per call. launches "
                 "are the four main paths' runs, read when each CLI "
                 "returns; max_abs_err is the largest over every shape "
                 "and type; library_ms of warp_grid_grad and of "
                 "splat_trilinear is the same F.grid_sample backward call, "
                 "which computes both. conv3d_k3_block, on no main path, "
                 "gives its totals over the 14 forward k3 convs of "
                 "UNet_light at 168x200x168 in bfloat16 (ms at its default "
                 "p_blk 4, and per p_blk and shape), timed by the block-conv "
                 "microbench in the convs phase, whose launches it counts "
                 "apart. device_ms and library_device_ms (the convolutions; "
                 "device_ms of the warp kernels too) "
                 "are the kernel's and the library call's queued times: the "
                 "stream held by a spin kernel while the host enqueues the "
                 "calls, so that they time the card's work without the "
                 "host's launch overhead, which ms and library_ms hold at "
                 "the smaller shapes. cuda_core_ms and cuda_core_device_ms "
                 "(deconv2x, conv3d_point) time the same bfloat16 calls on "
                 "the CUDA-core kernel of channel_mix.cuh, which they took "
                 "before the tensor-core kernel"})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
