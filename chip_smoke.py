#!/usr/bin/env python3
"""Smoke run of deepatlas_torch on one CUDA card: the quickest proof that
the PyTorch port builds, is right and runs its main path on the GPU.

Phases (one JSON line each, any failure exits nonzero before the last line):

  1. device  -- card name, ``nvidia-smi`` name and power limit; TF32 off for
     every float32 reference.
  2. build   -- compile the CUDA sources of deepatlas_torch/kernels/csrc
     (the ``ptxas`` report of every kernel logged, and per source the most
     registers a kernel uses and its spill bytes).
     native -- the native I/O library (``native/deepatlas_io.cpp``, g++
     and zlib, built into deepatlas_torch/kernels/_build) must build and
     read a small volume and its labels as the Python parser does; its
     build seconds are logged.
  3. kernels -- each kernel against its plain PyTorch version at every
     shape the seven main paths launch it at, in float32 and bfloat16 (the
     OAI patch path's convolutions in bfloat16, its type), with
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
     shapes.  The fixed UNet (unet_serving, unet_training): the same roles
     at its plan's shapes (A and D up to Cin 768, C at 512 -> 512, B at
     64 -> n_classes), with the weight-gradient kernel's float32 partial
     sums (``wgrad_partial_bytes``) logged per shape.  OAI patch training
     (oai_patch_training): UNet_light's training step on 2 x 128^3 with 5
     classes, and the field ``augment``: the trilinear warp (unclamped,
     one float32 channel) at 2 x 128^3 on the augmenter's rigid-plus-B-spline
     grid, samples outside the volume included, against its plain version
     and ``F.grid_sample``.
     Registration: one VoxelMorph step on a 168x200x168 pair --
     kernel A at its 11 forward (4 of them strided) and 10 input-gradient
     (4 strided: the parity-class launch in bfloat16, the stride-1 kernel
     on the zero-stuffed gradient in float32) shapes and the
     weight-gradient kernel at its 11 (4 strided), the
     transposed-conv kernel at the decoder's full-resolution upsample (also
     with the identity bank against ``nearest_resize``), and the three warp
     kernels (trilinear warp, its grid
     gradient, the splat) at 1x168x200x168 with one channel (the step's
     call) and two, in float32 and bfloat16, on a smooth field (up to 2.5
     voxels), on a saturated one (up to 20 voxels, clamped to 8) and on
     uniform noise of up to 8 voxels (adversarial), and at odd small shapes
     (3 channels; 33 in both types on a smooth and an adversarial field);
     the splat, which adds in 64-bit fixed point, twice and bit for bit;
     the splat of ones (``splat_ones``: no max pass) equal bit for bit to
     the general splat of a tensor of ones; then the differentiable
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
     plain versions), counted apart from the main paths; and the dice's
     per-class sums (``binned_sum``, fixed point, not a kernel) the same
     bits again and on permuted elements, against float64.  Block conv: the
     multi-plane k3 forward (kernel K, on no model path; bfloat16 on the
     tensor cores, where p_blk 2 must equal kernel A bit for bit, float32
     on the CUDA cores) against its plain version and against the k3 conv
     kernel at UNet_light's 13 forward k3 shapes at 168x200x168, at p_blk
     2, 4 and 8 in both types, and at one odd small shape whose depths are
     no multiple of p_blk (p_blk 1, 2, 3, 4 and 8).
  4. main    -- the segmentation serving path: a synthetic OAI-ZIB corpus
     (160x384x384 volumes, labels 0..4, from ``--seed``), UNet_light with
     seeded weights and BatchNorm statistics saved as a checkpoint, and
     ``infer_seg_torch.main`` at the documented OAI setting (tile 128^3,
     overlap 16, tile batch 4, bf16).  The launch counters must show 14 k3
     convs, 3 deconvs and 1 head per tile batch, every volume and mask
     must be read by the native tier (``read_counts``), the CLI's Dice
     lines must be finite, and one tile batch through the kernels must
     agree with the same net on the plain versions; the decode of one OAI
     image through the native tier and through the Python parser is
     timed.
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
     regime and one reg step with and without substitution, each twice
     through the kernels (the two compared bit for bit: ``rerun_*``, which
     must read 0.0 for the reg step) and on the plain versions: the
     parameter gradients within ``JOINT_GRAD_TOL``, the step's metrics
     within ``STEP_METRIC_TOL``; on the trained state each step is
     profiled, and the reg step is run again with one kernel at a time on
     its plain version (``reg_attribution``: which kernel's rounding moves
     the worst entry).  The seeded draw's untrained field is also measured on the
     first pair at the corpus's intensity and at three times it.
  8. convs   -- the conv tools: ``tools/bench_packed_conv_torch.py
     --before-after`` (the per-shape roofline of kernels A, B and C on
     UNet_light's forward at 168x200x168, then A, D, C and B in bf16 per
     shape on the tensor cores, on the CUDA cores and in cuDNN, in turns) and
     ``tools/bench_block_conv_torch.py`` (kernel K at p_blk 2, 4 and 8 on
     the tensor cores and on the CUDA cores against kernel A, cuDNN beside,
     in turns), ``--iters 3`` each, with
     their rows logged; each kernel must launch exactly as often as the
     tool called it, K's launches are the ones its kernels entry counts
     apart.  Run after the kernels phase, before the main paths.
  9. unet_serving -- ``infer_seg_torch.main --model UNet`` on one
     synthetic OAI volume with a seeded checkpoint of the fixed UNet (5
     classes, the serving setting above): 14 / 3 / 1 launches per tile
     batch, finite Dice, seconds per volume, and one tile batch's logits
     through the kernels against the plain versions.
 10. unet_train -- the segmentation experiment with ``"model": "UNet"``
     (bias, BatchNorm, 32 classes, bf16, batch 1, the MindBoggle recipe's
     168x200x168 crops) for ``UNET_TRAIN_STEPS`` steps and one validation:
     27 / 14 / 3 / 2 launches per step, a finite loss that falls, the
     step's median seconds, peak memory and kernel D's partial sums; then
     one step's gradients through the kernels against the plain versions
     (``unet_train_check``).
 11. oai_patch_training -- the segmentation experiment with the seg CLI's
     config and the patch keys: 3 synthetic 160x384x384 OAI volumes (2 to
     train, 1 to validate), UNet_light with 5 classes in bf16, balanced
     128^3 patches two a step, the augmenter (B-spline, rigid, blur; kernel
     E twice a step), 12 steps and one validation on the whole volume.
     Launches per step (27 / 14 / 3 / 2 and E 2), finite losses, the step's
     median seconds, patches per second, peak memory, the balanced
     sampler's host ms per crop by class, the augmenter's device ms by
     piece, one augmented batch against E's plain version, and the image
     summaries written.
 12. parallel -- the parallel tiers: 2 ranks spawned on the one card over
     gloo (NCCL refuses two ranks on one GPU; correctness, not scaling),
     one process group for every task, each task's launches counted per
     rank against its single-process table: ``infer_seg_torch.main
     --spatial-shards 2`` on a synthetic 160x384x384 OAI volume (its labels
     equal to the single-process whole-volume forward's); 3 spatial seg
     steps of the seg recipe (UNet_light, 32 classes, bf16, dice; SGD,
     ``PAR_LR``) and one float32 step at 2 shards of 80x200x168
     (``PAR_DEPTH``: the recipe's 168 does not split), one spatial
     VoxelMorph step, each against the same step on one process: losses,
     and the first step's gradients per tensor within the train phase's
     limits or 3 times the single-process step's own change under a
     rounding-sized change of its input (``COND_EPS``); the DP seg step at
     batch 2 against its function computed replica by replica in one
     process (equal bit for bit here); one DP joint seg and reg step (rank
     0 hard, rank 1 f_hard with a substituted side; the replicas' states
     equal); then ``train_seg_torch.py --data-parallel --debug`` over NCCL
     at a world of one, started by ``torch.distributed.run``, on a
     72x72x64 crop corpus (42 steps, falling losses).  The kernels phase
     holds A and D at depth padding 0 at the shards' shapes (path
     ``parallel``).
 13. remat -- rematerialization against the same steps without it, bit for
     bit (losses, gradients, BatchNorm statistics moved once, parameters,
     after the first and the last step), from one seeded state: (a)
     UNet_light on train_seg.py's recipe (168x200x168, 32 classes, bf16)
     and (b) VoxelMorph on train_reg.py's recipe (a pair of the reg phase's
     corpus), ``remat`` off and on, 8 steps each: the step's median
     seconds and peak memory, the launches per step against the table
     (remat adds one forward of every ConvBlock and DeconvBlock), and the
     remat UNet_light's serving forward (14 / 3 / 1 per tile batch); (c)
     the joint experiment's seg step, 4 steps per label regime, with
     ``checkpoint_seg_apply`` off and on (one more forward of the seg net
     per differentiated apply); (d) the fixed UNet through the seg
     experiment (``"model": "UNet"``, ``"remat"`` in its model settings, 5
     classes, BatchNorm, batch 1) on synthetic OAI volumes: 4 steps each
     way on their middle 80x384x384 (both peaks; the medians of (c) and
     (d) over the warm steps, all but the first), then 4 steps with remat
     on the whole 160x384x384 volume in a child process under PyTorch's
     expandable-segments allocator (``REMAT_WHOLE_ALLOC_CONF``; finite
     losses, the step's median seconds and peak; the peak without remat
     logged as the 80-plane reading scaled by depth, marked so).  Every
     remat peak must lie below
     its plain one.  The kernels phase holds the whole-volume step's A, B,
     C and D launches past 2^31 elements (A's 192-channel input and input
     gradient, C's 128-channel output; B's 64-channel head near it)
     against the same kernels on 40-plane depth slabs (A, B, C bit for
     bit, D's weight gradient the slabs' sum within ``TOL["float32"]``),
     the first slab against its plain version (path ``remat``), with B's
     and C's CUDA-core kernels timed on the same slabs.

The reg and joint phases also check their image summaries (every panel,
or a named ``deform_grid`` line where matplotlib does not import; the
validation's summary forward adds one VoxelMorph evaluation's launches).
Then the ``nvidia-smi`` line, the kernels summary line and, last,
``{"ok": true, "device": {...}}``.  Run with no arguments:
``python3 chip_smoke.py``.  ``python3 chip_smoke.py --remat-depths 128
144 160`` runs only the remat phase's whole-volume process at those OAI
depths, under PyTorch's default allocator and its expandable segments
(one JSON line each): the depth that fits one card.
"""
import argparse
import contextlib
import functools
import gc
import io
import json
import os
import re
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
    "conv3d_k3_block": ("deepatlas_torch/kernels/csrc/conv3d_mma.cu",
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
    "conv3d_k3_block": {
        "bfloat16": "deepatlas_torch/kernels/csrc/conv3d_mma.cu",
        "float32": "deepatlas_torch/kernels/csrc/conv3d_block.cu"},
}
# kernels whose reruns must be equal bit for bit: no atomics, or (the
# splat) integer atomics, whose sums do not depend on their order
DETERMINISTIC = ("conv3d_k3_wgrad", "deconv2x", "conv3d_point",
                 "splat_trilinear")
PATHS = ("serving", "training", "registration", "joint", "unet_serving",
         "unet_training", "oai_patch_training", "parallel", "remat")
# paths whose convolutions the kernels phase checks in bfloat16 only: the
# type they run in (their float32 checks would repeat the training path's)
BF16_ONLY_PATHS = ("oai_patch_training",)

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
# per-class sums (binned_sum, fixed point, the same bits in any order) and
# the same per-point gradients
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


# OAI patch training (the seg experiment's patch keys): the serving tile as
# the patch, two patches a step from the balanced sampler, the example of
# make_augmenter's docstring, 12 steps and one validation on the whole
# validation volume
PATCH = (TILE,) * 3
PATCH_BATCH = 2
PATCH_STEPS = 12
N_PATCH_VOLUMES = 3                 # 2 for training, 1 for validation
PATCH_AUGMENTATION = {
    "bspline": {"mesh_size": [3, 3, 3], "deform_scale": 2.0, "ratio": 0.5},
    "rigid": {"rotation_angles": [5, 5, 5], "translation": [2, 2, 2],
              "ratio": 0.5, "mode": "both"},
    "blur": {"sigma": 0.7, "ratio": 0.3}}
# the augmenter's launches per batch: the B-spline and the rigid image warp
# on kernel E, one launch each over the batch (drawn or not: an element not
# drawn warps by the identity); the label warps and the blur are plain
AUGMENT_LAUNCHES = dict(NO_LAUNCHES, warp_trilinear=2)
PATCH_STEP_LAUNCHES = add_launches(STEP_LAUNCHES, AUGMENT_LAUNCHES)
# the image summaries of one validation: the first validation pair's
# eval-mode VoxelMorph forward (the joint experiment adds the seg net's
# evaluation of its moving volume, which its eval recorder counts)
SUMMARY_LAUNCHES = REG_EVAL_LAUNCHES


def log(obj):
    print(json.dumps(obj), flush=True)


def optional_imports():
    """Whether matplotlib (the ``deform_grid`` summaries) and tensorboard
    (the event files beside ``images/``) import."""
    import importlib

    out = {}
    for name in ("matplotlib", "tensorboard"):
        try:
            importlib.import_module(name)
            out[name] = True
        except ImportError:
            out[name] = False
    return out


def written_images(log_root):
    """The image summaries under ``log_root``: ``{tag: {"steps", "shape",
    "min", "max"}}`` from every ``images/<tag>/<step>.npy``, and the number
    of TensorBoard event files beside them."""
    images, events = {}, 0
    for dirpath, _, files in os.walk(log_root):
        events += sum(f.startswith("events.out.tfevents") for f in files)
        if os.path.basename(os.path.dirname(dirpath)) != "images":
            continue
        tag = os.path.basename(dirpath).replace("__", "/")
        for name in sorted(files):
            img = np.load(os.path.join(dirpath, name))
            entry = images.setdefault(tag, {"steps": [], "shape": None,
                                            "min": 1.0, "max": 0.0})
            entry["steps"].append(int(name[:-4]))
            entry["shape"] = list(img.shape)
            entry["min"] = min(entry["min"], float(img.min()))
            entry["max"] = max(entry["max"], float(img.max()))
    return images, events


def check_images(phase, images, want_tags, cli_lines):
    """Every tag of ``want_tags`` written as a (3, H, W) image in [0, 1];
    a ``deform_grid`` tag may instead be named on a line of its own where
    matplotlib does not import."""
    for tag in want_tags:
        if tag.endswith("deform_grid") and tag not in images:
            if any(f"{tag} not written" in ln for ln in cli_lines):
                continue
        got = images.get(tag)
        if got is None or len(got["shape"]) != 3 or got["shape"][0] != 3 \
                or not 0.0 <= got["min"] <= got["max"] <= 1.0:
            raise AssertionError(f"{phase}: image summary {tag}: {got}")


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


def unet_cases(path, batch, dhw, n_classes, train, model="UNet_light"):
    """Every launch of one forward of the U-Net ``model`` (UNet_light or the
    fixed UNet; with ``train``, of its backward too) on a ``(batch, *dhw,
    1)`` input, as ``{(path, kernel, role, batch, dhw, cin, cout):
    launches}``.  Roles: ``forward``; ``dx`` (the same kernel on the
    upstream gradient, Cin and Cout swapped; the first conv's input needs
    none); ``wgrad``."""
    from deepatlas_torch import models

    encoders, decoders = {
        "UNet_light": (models.UNET_LIGHT_ENCODERS,
                       models.UNET_LIGHT_DECODERS),
        "UNet": (models.UNET_ENCODERS, models.UNET_DECODERS)}[model]
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
    for i, plan in enumerate(encoders):
        for f in (plan if i == 0 else plan[1:]):
            conv(size, cin, f, first=cin == 1)
            cin = f
        if i < len(encoders) - 1:
            skips.append(cin)
            size = tuple(n // 2 for n in size)
    for plan in decoders:
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


def cuda_core_call(name, x, w):
    """The call of ``name`` (one of ``CUDA_CORE_TWINS``) on its CUDA-core
    kernel, through its C entry point, with ``x`` and the weights ``w``."""
    from deepatlas_torch.kernels import conv3d, deconv3d
    from deepatlas_torch.kernels.conv3d import kernel_operands

    simt = {"deconv2x": deconv3d._deconv_simt,
            "conv3d_point": conv3d._point_simt}[name]
    return functools.partial(simt, x, kernel_operands(x, w, None)[0], None)


def all_cases():
    cases = unet_cases("serving", TILE_BATCH, (TILE,) * 3, N_CLASSES, False)
    cases.update(unet_cases("training", 1, TRAIN_SHAPE, TRAIN_CLASSES, True))
    cases.update(voxelmorph_cases("registration", 1, TRAIN_SHAPE))
    cases.update(unet_cases("unet_serving", TILE_BATCH, (TILE,) * 3,
                            N_CLASSES, False, model="UNet"))
    cases.update(unet_cases("unet_training", 1, TRAIN_SHAPE, TRAIN_CLASSES,
                            True, model="UNet"))
    cases.update(unet_cases("oai_patch_training", PATCH_BATCH, PATCH,
                            N_CLASSES, True))
    cases.update(parallel_cases())
    return cases


def wgrad_partial_bytes(dtype_name, batch, dhw, cin, cout, stride=1,
                        pad_d=1):
    """Bytes of the float32 partial sums ``(chunks, 27, Cin, Cout)`` that
    the weight-gradient kernel of this type allocates for one call."""
    from deepatlas_torch.kernels import build, conv3d

    if dtype_name == "bfloat16":
        lib = build.load("conv3d_mma", conv3d._MMA_SIGNATURES)
        chunks = lib.conv3d_k3_wgrad_mma_chunks(batch, *dhw, cin, cout,
                                                   stride, pad_d)
    else:
        lib = build.load("conv3d_wgrad", conv3d._WGRAD_SIGNATURES)
        chunks = lib.conv3d_k3_wgrad_chunks(batch, *dhw, cin, cout,
                                               stride, pad_d)
    return chunks * 27 * cin * cout * 4


def slab_check(name, role, got, args, kw):
    """A depth-padding-0 launch against the full-volume conv (depth padding
    1) on the same input: the forward is the padded conv's slab (its
    planes 1..D-2 at stride 1; at stride 2 the conv of the input from
    plane 1, whose output o reads the same planes 2o .. 2o + 2 for every o
    but the first, which reads its zero padding: compared from o = 1), the
    stride-1 input gradient is the padded conv's of the upstream gradient
    with a zero plane on each side.  Both add the same products in the
    same order, so float32 must be equal bit for bit.  None for the other
    roles."""
    import torch.nn.functional as F

    from deepatlas_torch.kernels import conv3d_k3, conv3d_k3_input_grad
    stride = kw.get("stride", 1)
    if name == "conv3d_k3" and role in ("forward", "forward_s2"):
        x, w, bias = args
        if stride == 1:
            full = conv3d_k3(x, w, bias)[:, 1:-1]
        else:
            full = conv3d_k3(x[:, 1:].contiguous(), w, bias,
                             stride=2)[:, 1:got.shape[1]]
            got = got[:, 1:]
    elif role == "dx":
        g, w = args
        full = conv3d_k3_input_grad(F.pad(g, (0, 0, 0, 0, 0, 0, 1, 1)), w,
                                    kw["dhw"], 1)
    else:
        return None
    return {"equal": bool(got.shape == full.shape and
                          bool((got == full).all())),
            "max_abs_err": (got.float() - full.float()).abs().max().item()}


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


def library_call(kernel, x, w, stride=1, dhw=None, pad_d=1):
    """One PyTorch (cuDNN) call computing the same function: the yardstick
    for ``library_ms`` only; the port never calls it.  For the weight
    gradient ``w`` is the upstream gradient; with ``dhw`` (the input's
    size) the k3 conv's call is its input gradient, ``x`` the upstream
    gradient and ``w`` the conv's weights.  ``pad_d`` is the k3 conv's
    depth padding (0: cuDNN with padding (0, 1, 1))."""
    import torch
    import torch.nn.functional as F

    pad = (pad_d, 1, 1)
    xc = x.permute(0, 4, 1, 2, 3)           # NDHWC storage, NCDHW view
    if dhw is not None:
        wk = w.to(x.dtype).permute(4, 3, 0, 1, 2)
        size = (x.shape[0], w.shape[-2]) + tuple(dhw)
        return lambda: torch.nn.grad.conv3d_input(size, wk, xc,
                                                  stride=stride, padding=pad)
    if kernel == "conv3d_k3_wgrad":
        gc = w.permute(0, 4, 1, 2, 3)
        size = (w.shape[-1], x.shape[-1], 3, 3, 3)
        return lambda: torch.nn.grad.conv3d_weight(xc, size, gc,
                                                   stride=stride,
                                                   padding=pad)
    wk = w.to(x.dtype)
    if kernel == "conv3d_k3":
        return lambda: F.conv3d(xc, wk.permute(4, 3, 0, 1, 2), stride=stride,
                                padding=pad)
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

    from deepatlas_torch.kernels import (KERNELS, conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain)
    from deepatlas_torch.kernels.conv3d import strided_shape

    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "flops", "bytes",
            *DEVICE_TIMES, *CUDA_CORE_TIMES)
    summary = {name: dict({path: dict.fromkeys(keys, 0.0) for path in PATHS},
                          max_abs_err=0.0)
               for name in KERNELS}
    for (path, name, role, batch, size, cin, cout), per_unit in \
            all_cases().items():
        fn, plain = KERNELS[name]
        # depth padding 0 (the parallel path): the kernel's input is the
        # shard with one halo plane on each side
        p0 = role.endswith("_p0")
        base = "forward" if role == "serve_p0" else \
            role[:-3] if p0 else role
        pad_d = 0 if p0 else 1
        if p0:
            size = (size[0] + 2,) + tuple(size[1:])
        n = batch * int(np.prod(size))
        big = n * max(cin, cout) > 2e8      # fewer repeats on the largest
        stride = 2 if base.endswith("_s2") else 1
        kw = {"stride": 2} if stride == 2 else {}
        if p0:
            kw["pad_d"] = 0
        out_size = strided_shape(size, stride, pad_d)
        n_out = batch * int(np.prod(out_size))
        in_size = size
        work_role = base
        if base == "dx_s2" or (p0 and base.startswith("dx")):
            # the conv's input gradient: the upstream gradient (cin
            # channels at the output's size) to the input (cout channels);
            # at depth padding 0 the input's halo planes too
            fn, plain = conv3d_k3_input_grad, conv3d_k3_input_grad_plain
            kw = {"dhw": size, "stride": stride, "pad_d": pad_d}
            in_size = out_size
            work_role = "dx_s2"
        dtypes = (torch.bfloat16,) if path in BF16_ONLY_PATHS \
            or role == "serve_p0" else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]
            x = (torch.rand((batch,) + tuple(in_size) + (cin,), generator=gen,
                            device="cuda") * 2 - 1).to(dtype)
            if work_role == "dx_s2":
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
            slab = slab_check(name, base, got, args, kw) if p0 else None
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
            if slab is not None and dname == "float32":
                # the full-volume conv's slab, bit for bit in float32
                ok = ok and slab["equal"]
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
                               size if work_role == "dx_s2" else None,
                               pad_d)
            lib_ms = cuda_ms(lib, reps=3 if big else 5)
            dev_ms = cuda_ms(lambda: fn(*timed_args, **kw),
                             reps=3 if big else 5, queued=True)
            lib_dev_ms = cuda_ms(lib, reps=3 if big else 5, queued=True)
            # the bfloat16 channel mix's earlier kernel, on the CUDA cores
            # through its C entry point, on the same inputs
            simt = simt_ms = simt_dev_ms = None
            if name in CUDA_CORE_TWINS and dname == "bfloat16":
                simt = cuda_core_call(name, x, second)
                simt_ms = cuda_ms(simt, reps=5)
                simt_dev_ms = cuda_ms(simt, reps=5, queued=True)
            bms, bound_by = bound_ms(name, n, cin, cout, dname, n_out,
                                     work_role)
            partial_bytes = wgrad_partial_bytes(
                dname, batch, size, cin, cout, stride, pad_d) \
                if name == "conv3d_k3_wgrad" else None
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
                 "bound_ms": bms, "bound_by": bound_by,
                 "wgrad_partial_bytes": partial_bytes, "pad_d": pad_d,
                 "full_volume_slab": slab})
            if not ok:
                raise AssertionError(f"{name} {role} {dname} "
                                     f"{tuple(x.shape)} -> {cout}: max|k-p| "
                                     f"{err} (limit {tol} * {scale}), "
                                     f"bit-identical rerun {repeatable}, "
                                     f"full-volume slab {slab}")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
            if dname == "bfloat16":       # the main paths' type, per unit
                flops, nbytes = work(name, n, cin, cout, dname, n_out,
                                     work_role)
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


def noise_grid(shape, max_disp, gen):
    """A deformation grid ``(B, D, H, W, 3)`` on the card: the identity
    plus uniform noise of up to ``max_disp`` voxels per axis and voxel (no
    training regime makes it; the worst case for the gathers' locality)."""
    import torch

    from deepatlas_torch.ops import identity_grid_batch, normalize_displacement

    disp = (torch.rand(tuple(shape) + (3,), generator=gen, device="cuda")
            * 2 - 1) * max_disp
    return (normalize_displacement(disp)
            + identity_grid_batch(shape, device="cuda")).contiguous()


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
    "splat_trilinear": {"ones": 2, (TRAIN_CLASSES, "bfloat16"): 1,
                        (TRAIN_CLASSES, "float32"): 1}}


def check_warp_kernels(summary, seed):
    """Phase 3, warp kernels: E, F and G against their plain versions, with
    kernel / plain / library (``F.grid_sample``, timed on float32 values:
    it wants the grid in the values' type, and a bfloat16 grid cannot
    address 168 voxels) times.  Its one backward call computes both the
    grid gradient and the splat, so that time stands beside each of them.
    The cases: 1, 2 and 32 channels (the registration step's image warp
    and its grid gradient; the joint training's anatomy warps and splats)
    in float32 and bfloat16 on the smooth, the saturated and the
    adversarial field, the f-hard branch's float32 one-hot splat, and odd
    small shapes (3 channels; 33 in both types on two fields).  The splat
    (``DETERMINISTIC``) runs twice and must give the same bits; the splat
    of ones (``splat_ones``) must give the general path's bits on a tensor
    of ones, and its time stands for the joint unit's two such calls.
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
    # gradient): C = 1, 2 and 32 in both types on the three fields, the
    # f-hard branch's float32 one-hot splat, odd small shapes (3 channels;
    # 33 in both types on a smooth and an adversarial field)
    cases = [(field, full, c, dtype, amp, False)
             for c in (1, 2, TRAIN_CLASSES)
             for dtype in (torch.float32, torch.bfloat16)
             for field, amp in (("smooth", 2.5), ("saturated", 20.0),
                                ("adversarial", REG_MAX_DISP))]
    cases += [("smooth", full, TRAIN_CLASSES, torch.float32, 2.5, True),
              ("odd", (2, 13, 17, 11), 3, torch.float32, 3.0, False)]
    cases += [(field, (2, 9, 10, 13), 33, dtype, amp, False)
              for dtype in (torch.float32, torch.bfloat16)
              for field, amp in (("odd", 3.0),
                                 ("odd adversarial", REG_MAX_DISP))]
    per_call = {}
    for field, shape, c, dtype, amp, onehot in cases:
        dname = str(dtype).split(".")[1]
        big = shape == full
        raw = noise_grid(shape, amp, gen) if "adversarial" in field \
            else smooth_grid(shape, amp, seed)
        grid = clamp_displacement(raw, REG_MAX_DISP).contiguous()
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

        # the splat of ones (the anatomy dice's): no max pass, no cotangent;
        # the same bits as the general path on a tensor of ones
        if big and c == 1 and dtype == torch.float32:
            ones = torch.ones(shape + (1,), device="cuda")
            got = kernels.splat_ones(grid, shape[1:])
            same = bool(torch.equal(got, kernels.splat_trilinear(
                ones, grid, shape[1:]))) and bool(torch.equal(
                    got, kernels.splat_ones(grid, shape[1:])))
            del got
            ones_fn = functools.partial(kernels.splat_ones, grid, shape[1:])
            general = functools.partial(kernels.splat_trilinear, ones, grid,
                                        shape[1:])
            times = {"ms": cuda_ms(ones_fn, reps=5),
                     "device_ms": cuda_ms(ones_fn, reps=5, queued=True),
                     "general_ms": cuda_ms(general, reps=5),
                     "general_device_ms": cuda_ms(general, reps=5,
                                                  queued=True),
                     "plain_ms": cuda_ms(lambda: kernels.splat_trilinear_plain(
                         ones, grid, shape[1:]), reps=2)}
            log({"phase": "kernels", "kernel": "splat_trilinear",
                 "role": "splat_ones (the splat of ones)", "path": "joint",
                 "field": field, "vol": list(shape) + [1],
                 "equals_general_path_and_rerun": same, **times})
            if not same:
                raise AssertionError(f"splat_ones {field}: not the general "
                                     f"path's bits on ones, or not the same "
                                     f"bits again")
            if field == "smooth":
                per_call[("splat_ones",)] = dict(
                    ms=times["ms"], plain_ms=times["plain_ms"],
                    device_ms=times["device_ms"], flops=0.0,
                    bytes=float(n * 16), bound_ms=n * 16 / HBM_BYTES_PER_S
                    * 1e3, library_ms=per_call[
                        ("splat_trilinear", 1, "float32", False)][
                        "library_ms"])
            del ones, ones_fn, general

        # the differentiable entry point: dvol through the splat and dgrid
        # through the grid gradient, the clamp's mask included, against the
        # same Function on the plain versions
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
            call = per_call[("splat_ones",) if key == "ones"
                            else (name,) + key + (False,)]
            for k, v in call.items():
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


def augment_grid(seed):
    """The OAI patch batch's augmentation field on the card: each
    element's rigid grid (rotation and translation of ``PATCH_AUGMENTATION``
    drawn from ``seed``) plus its B-spline displacement, both applied, as
    ``(PATCH_BATCH, *PATCH, 3)`` float32; samples outside the volume
    included."""
    from deepatlas_torch.data import augment

    aug = augment.make_augmenter(PATCH_AUGMENTATION)
    draws = aug.draw((seed, 2 ** 20), PATCH_BATCH)
    ctrl = draws["bspline"][0].cuda()
    angles, trans = (t.cuda() for t in draws["rigid"][:2])
    disp = augment.bspline_field_from_ctrl(
        ctrl, PATCH, aug.bspline_args["mesh_size"], aug.bspline_args["order"])
    return (augment.rigid_grid(angles, trans, PATCH) + disp).contiguous()


def check_augment_field(summary, seed):
    """Phase 3, the field ``augment``: kernel E (unclamped, one float32
    channel, ``PATCH_BATCH`` x 128^3) on the augmenter's rigid-plus-B-spline
    grid against its plain version (``WARP_TOL``) and ``F.grid_sample``,
    with event, queued and library times and the byte bound.  Fills the
    OAI patch unit of E: the augmenter's two launches a step."""
    import torch
    import torch.nn.functional as F

    from deepatlas_torch import kernels

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    grid = augment_grid(seed)
    vol = torch.rand((PATCH_BATCH,) + PATCH + (1,), generator=gen,
                     device="cuda")
    outside = (grid.abs() > 1).any(dim=-1).float().mean().item()
    vol_l = vol.permute(0, 4, 1, 2, 3)

    def fn():
        return kernels.warp_trilinear(vol, grid)

    def plain():
        return kernels.warp_trilinear_plain(vol, grid)

    def library():
        return F.grid_sample(vol_l, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    got, ref = fn(), plain()
    lib = library().permute(0, 2, 3, 4, 1)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    lib_err = (got - lib).abs().max().item()
    tol = WARP_TOL["warp_trilinear"]["float32"]
    ok = bool(np.isfinite(err)) and err <= tol * scale \
        and got.shape == ref.shape and got.dtype == ref.dtype
    del got, ref, lib
    n = int(np.prod(grid.shape[:4]))
    nbytes = warp_bytes("warp_trilinear", n, 1, 4)
    times = {"ms": cuda_ms(fn, reps=10),
             "device_ms": cuda_ms(fn, reps=10, queued=True),
             "plain_ms": cuda_ms(plain, reps=3),
             "library_ms": cuda_ms(library, reps=10),
             "library_device_ms": cuda_ms(library, reps=10, queued=True),
             "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    log({"phase": "kernels", "kernel": "warp_trilinear",
         "path": "oai_patch_training", "field": "augment",
         "dtype": "float32", "vol": list(vol.shape), "max_disp": None,
         "samples_outside_volume": outside, "max_abs_err": err,
         "max_abs_ref": scale, "rel_tol": tol,
         "max_abs_diff_f_grid_sample": lib_err, "ok": ok,
         "kernel_ms": times["ms"], "kernel_device_ms": times["device_ms"],
         "plain_ms": times["plain_ms"], "library_ms": times["library_ms"],
         "library_device_ms": times["library_device_ms"],
         "library": "F.grid_sample forward", "bound_ms": times["bound_ms"],
         "bound_by": "bytes"})
    if not ok or not outside > 0:
        raise AssertionError(f"warp_trilinear on the augment field: max|k-p| "
                             f"{err} > {tol} * {scale}, or no sample outside "
                             f"the volume ({outside})")
    summary["warp_trilinear"]["max_abs_err"] = max(
        summary["warp_trilinear"]["max_abs_err"], err)
    unit = summary["warp_trilinear"]["oai_patch_training"]
    per_step = AUGMENT_LAUNCHES["warp_trilinear"]
    for key in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
        unit[key] += per_step * times[key]
    unit["bytes"] += per_step * float(nbytes)
    del vol, vol_l, grid
    torch.cuda.empty_cache()

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

    # the anatomy dice's per-class sums (fixed point: integer terms added
    # in float64 by index_add_, not a kernel): against float32 index_add_ at
    # one address per class; the same bits again, and on the elements in
    # another order
    from deepatlas_torch.kernels.anatomy import _BIN_LANES, binned_sum
    lab = block_labels(full).long()
    vals = torch.rand(lab.shape, generator=gen, device="cuda")

    def one_lane():
        return torch.zeros(TRAIN_CLASSES, device="cuda").index_add_(
            0, lab.reshape(-1), vals.reshape(-1))

    ref = one_lane()
    got = binned_sum(vals, lab, TRAIN_CLASSES)
    order = torch.randperm(lab.numel(), generator=gen, device="cuda")
    same = bool(torch.equal(got, binned_sum(vals, lab, TRAIN_CLASSES))) \
        and bool(torch.equal(got, binned_sum(vals.reshape(-1)[order],
                                             lab.reshape(-1)[order],
                                             TRAIN_CLASSES)))
    exact = torch.zeros(TRAIN_CLASSES, dtype=torch.float64,
                        device="cuda").index_add_(
        0, lab.reshape(-1), vals.reshape(-1).double())
    err = ((got.double() - exact).abs().max() / exact.abs().max()).item()
    err_one_lane = ((ref.double() - exact).abs().max()
                    / exact.abs().max()).item()
    log({"phase": "kernels", "path": "joint",
         "kernel": "binned_sum (fixed point by float64 index_add_, not a "
                   "kernel)",
         "labels": list(lab.shape), "classes": TRAIN_CLASSES,
         "lanes": _BIN_LANES,
         "ms": cuda_ms(lambda: binned_sum(vals, lab, TRAIN_CLASSES), reps=5),
         "device_ms": cuda_ms(lambda: binned_sum(vals, lab, TRAIN_CLASSES),
                              reps=5, queued=True),
         "one_lane_ms": cuda_ms(one_lane, reps=5),
         "one_lane_device_ms": cuda_ms(one_lane, reps=5, queued=True),
         "rel_err_vs_float64": err, "one_lane_rel_err_vs_float64":
             err_one_lane, "same_bits_rerun_and_permuted": same})
    # float32 sums of 176 k values in [0, 1) per class: the fixed point is
    # exact to 2^-28 a term and one float32 rounding
    if not (err <= 1e-6 and same):
        raise AssertionError(f"binned_sum: {err} against float64, same "
                             f"bits {same}")
    return apart


# kernel K at the block-conv microbench's p_blk values on UNet_light's
# forward shapes; the odd shape's depths are no multiple of the p_blk values
# beside them (the tail block)
BLOCK_P_BLKS = (2, 4, 8)
BLOCK_DEFAULT_P_BLK = 4          # conv3d_k3_block's default
BLOCK_TAIL = {"hw": (13, 37), "cin": 24, "cout": 40, "depths": (7, 10, 12),
              "p_blks": (1, 2, 3, 4, 8)}
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
    (the CUDA cores, ``csrc/conv3d_block.cu``) and bfloat16 (the tensor
    cores, ``csrc/conv3d_mma.cu``, where p_blk 2 is kernel A's own instance
    and must equal it bit for bit), under A's limits (``TOL``); then at one
    odd small shape whose depths 7, 10 and 12 are no multiple of most of
    the p_blk values 1, 2, 3, 4 and 8.  The plain version is timed in
    bfloat16 at the forward's shapes (K's own times come from the convs
    phase).  Returns ``{"max_abs_err",
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
            a_out = conv3d_k3(x, w)
            a = a_out.float()
            scale = ref.abs().max().item()
            errs, diffs = {}, {}
            # bfloat16 at p_blk 2 is A's own tensor-core instance
            same_as_a = None
            for p in p_blks:
                got = conv3d_k3_block(x, w, p_blk=p)
                torch.cuda.synchronize()
                if got.shape != shape + (cout,) or got.dtype != dtype:
                    raise AssertionError(
                        f"conv3d_k3_block p_blk={p} {shape}: gives "
                        f"{tuple(got.shape)} {got.dtype}")
                if p == 2 and dtype == torch.bfloat16:
                    same_as_a = bool(torch.equal(got, a_out))
                got = got.float()
                errs[p] = (got - ref).abs().max().item()
                diffs[p] = (got - a).abs().max().item()
                del got
            limit = TOL[dname] * scale
            ok = all(np.isfinite(e) and e <= limit
                     for e in (*errs.values(), *diffs.values())) \
                and same_as_a is not False
            rec = {"phase": "kernels", "path": "block_conv",
                   "kernel": "conv3d_k3_block", "dtype": dname,
                   "source": SOURCES_BY_DTYPE["conv3d_k3_block"][dname],
                   "x": list(x.shape), "cin": cin, "cout": cout,
                   "calls_per_forward": n, "max_abs_err_vs_plain": errs,
                   "max_abs_diff_vs_conv3d_k3": diffs,
                   "p_blk_2_equals_conv3d_k3": same_as_a,
                   "max_abs_ref": scale, "rel_tol": TOL[dname], "ok": ok}
            if dname == "bfloat16" and n:
                rec["plain_ms"] = out["plain_ms"][(shape[1:], cin, cout)] = \
                    cuda_ms(lambda: conv3d_k3_block_plain(x, w), reps=1,
                            warmup=0)
            log(rec)
            if not ok:
                raise AssertionError(
                    f"conv3d_k3_block {dname} {tuple(x.shape)} -> {cout}: "
                    f"vs plain {errs}, vs conv3d_k3 {diffs}, limit {limit}"
                    f", p_blk 2 equal to conv3d_k3 {same_as_a}")
            out["max_abs_err"] = max(out["max_abs_err"], *errs.values())
            out["max_abs_diff_vs_a"] = max(out["max_abs_diff_vs_a"],
                                           *diffs.values())
            del x, w, ref, a, a_out
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
        "sources": SOURCES_BY_DTYPE["conv3d_k3_block"],
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
        "cuda_core_ms": totals["k_simt_ms"][BLOCK_DEFAULT_P_BLK],
        "p_blk": {str(p): {"ms": totals["k_ms"][p],
                           "cuda_core_ms": totals["k_simt_ms"][p],
                           "per_shape_ms": [
                               {"x": r["x"], "cin": r["cin"],
                                "cout": r["cout"], "calls_per_forward": r["n"],
                                "ms": r["k_ms"][p],
                                "cuda_core_ms": r["k_simt_ms"][p],
                                "conv3d_k3_ms": r["a_ms"],
                                "library_ms": r["library_ms"]}
                               for r in rows]}
                  for p in BLOCK_P_BLKS}}


def write_corpus(root, seed, n_volumes=N_VOLUMES):
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
    for v in range(n_volumes):
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


def decode_seconds(path, reps=2):
    """Host seconds to read one NIfTI file through the native tier and
    through the Python parser, in turns (the best of ``reps`` each)."""
    from deepatlas_torch.data import read_nifti

    out = {"native": [], "python": []}
    for _ in range(reps):
        for key, prefer in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            read_nifti(path, prefer_native=prefer)
            out[key].append(time.perf_counter() - t0)
    return {f"{k}_s": min(v) for k, v in out.items()}


def run_main_path(seed, workdir):
    import torch

    import infer_seg_torch
    from deepatlas_torch.data import (Partition, read_counts, read_nifti,
                                      reset_read_counts)
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
    reset_read_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        infer_seg_torch.main(argv)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    counts = launch_counts()
    reads = read_counts()
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
    reads_want = {"native": 2 * N_VOLUMES, "fallback": 0}
    log({"phase": "main", "volumes": N_VOLUMES, "volume_shape": OAI_SHAPE,
         "tiles_per_volume": n_tiles, "tile_batches": batches,
         "nifti_reads": reads, "nifti_reads_expected": reads_want,
         "launches": counts, "launches_expected": want,
         "setup_s": setup_s, "infer_s": infer_s,
         "seconds_per_volume": infer_s / N_VOLUMES,
         "tiles_per_s": N_VOLUMES * n_tiles / infer_s,
         "max_memory_allocated": peak, "cli_lines": lines})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if reads != reads_want:
        raise AssertionError(f"the CLI's reads {reads}, expected every "
                             f"volume and mask native: {reads_want}")

    model.load_state_dict(sd)
    model.to("cuda").eval()
    reset_read_counts()
    stages = stage_seconds(model, workdir, names[0])
    stage_reads = read_counts()
    if stage_reads != {"native": 2, "fallback": 0}:
        raise AssertionError(f"stage_s read {stage_reads}, not natively")
    decode = decode_seconds(os.path.join(workdir,
                                         f"{names[0]}_image.nii.gz"))

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
         "stage_s": stages, "stage_nifti_reads": stage_reads,
         "decode_one_oai_image_s": decode, "logits_vs_plain": agree,
         "mean_dice": means[0]})
    return counts


def mindboggle_volume(rng, shape=MB_SHAPE):
    """One synthetic MindBoggle-layout volume and its labels, drawn from
    ``rng``: a 4 x 4 x 2 grid of blocks labelled 0..31 (block borders
    jittered) whose intensity follows the label, plus noise."""
    index = []
    for n, blocks in zip(shape, (4, 4, 2)):
        cuts = (np.arange(1, blocks) / blocks
                + rng.uniform(-0.04, 0.04, blocks - 1)) * n
        index.append(np.searchsorted(cuts, np.arange(n)))
    seg = ((index[0][:, None, None] * 4 + index[1][None, :, None]) * 2
           + index[2][None, None, :]).astype(np.uint8)
    img = ((seg.astype(np.float32) + 1) / (TRAIN_CLASSES + 1)
           + 0.005 * rng.standard_normal(shape).astype(np.float32))
    return img, seg


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
        img, seg = mindboggle_volume(rng, shape)
        write_nifti(os.path.join(img_dir, f"{name}.nii.gz"), img)
        write_nifti(os.path.join(seg_dir, f"{name}.nii.gz"), seg)
    lists = {"MMRR-21-flip.txt": names[:n_train],
             "NKI-RS-21-valid.txt": names[n_train:],
             "NKI-RS-21-train.txt": names[n_train:]}
    for fname, members in lists.items():
        with open(os.path.join(mb, fname), "w") as f:
            f.write("".join(f"{n}\n" for n in members))
    return names


# each kernel's launching functions and the plain math that replaces them:
# (module, launcher, plain)
PLAIN_OF = {
    "conv3d_k3": (("conv3d", "_k3_cuda", "_k3_math"),
                  ("conv3d", "_dx_cuda", "_dx_math")),
    "conv3d_k3_wgrad": (("conv3d", "_wgrad_cuda", "_wgrad_math"),),
    "conv3d_point": (("conv3d", "_point_cuda", "_point_math"),),
    "deconv2x": (("deconv3d", "_deconv_cuda", "_deconv_math"),),
    "warp_trilinear": (("warp", "_warp_cuda", "_warp_math"),),
    "warp_grid_grad": (("warp", "_grid_grad_cuda", "_grid_grad_math"),),
    "splat_trilinear": (("warp", "_splat_cuda", "_splat_math"),),
    "matched_warp": (("anatomy", "_matched_cuda", "_matched_math"),),
    "matched_warp_fused": (("anatomy", "_fused_cuda", "_fused_math"),),
    "matched_grid_grad": (("anatomy", "_grid_grad_cuda", "_grid_grad_math"),),
}


@contextlib.contextmanager
def plain_math(names=None):
    """Run the wrappers' autograd Functions on the plain versions' math on
    the card (for the comparison only: nothing in the port does this):
    every kernel's, or only those of the kernels ``names``."""
    from deepatlas_torch import kernels

    with contextlib.ExitStack() as stack:
        for name in PLAIN_OF if names is None else names:
            for module, launcher, plain in PLAIN_OF[name]:
                mod = getattr(kernels, module)
                stack.enter_context(mock.patch.object(
                    mod, launcher, getattr(mod, plain)))
        yield


class StepRecorder:
    """Wraps an experiment's step factories to record, per training step,
    its loss (``loss_of`` the step's return value), its seconds
    (synchronised) and the kernels it launched, and per evaluated volume or
    pair its launches.  With ``track_peak`` each step also records its peak
    memory (the card's peak reset before it)."""

    def __init__(self, loss_of=lambda out: float(out[1]), track_peak=False):
        self.loss_of = loss_of
        self.track_peak = track_peak
        self.losses, self.seconds, self.step_launches = [], [], []
        self.eval_launches, self.peaks = [], []
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
                if self.track_peak:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if self.first_start is None:
                    self.first_start = t0
                out = step(state, *tensors)
                torch.cuda.synchronize()
                self.last_end = time.perf_counter()
                if self.track_peak:
                    self.peaks.append(torch.cuda.max_memory_allocated())
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


def seg_gradient_agreement(model, criterion, x, y):
    """One seg training step's parameter gradients through the kernels
    against the same step on the plain versions, in bfloat16 (held in the
    mean over a tensor's entries) and in float32 (at the worst entry), per
    tensor relative to its largest entry (``GRAD_TOL``), and the losses
    (``NET_TOL``).  Returns ``{dtype: {..., "ok"}}``; the model is left in
    float32."""
    import torch

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
    return agree


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

    agree = seg_gradient_agreement(model, criterion, x, y)
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

    mb = os.path.join(root, "mindboggle")
    img_dir = os.path.join(mb, "image_in_MNI152_normalized")
    seg_dir = os.path.join(mb, "label_31_reID_merged")
    os.makedirs(img_dir)
    os.makedirs(seg_dir)
    n_train = N_REG_TRAIN_VOLUMES
    names = [f"synth_{v}" for v in range(n_train + N_REG_VALID_VOLUMES)]
    for name, (img, seg) in zip(names, reg_volumes(seed, shape, max_shift,
                                                   intensity)):
        write_nifti(os.path.join(img_dir, f"{name}.nii.gz"), img)
        write_nifti(os.path.join(seg_dir, f"{name}.nii.gz"), seg)
    lists = {"MMRR-21-flip.txt": names[:n_train],
             "NKI-RS-21-valid.txt": names[n_train:],
             "NKI-RS-21-train.txt": names[n_train:]}
    for fname, members in lists.items():
        with open(os.path.join(mb, fname), "w") as f:
            f.write("".join(f"{n}\n" for n in members))
    return names


def reg_volumes(seed, shape=MB_SHAPE, max_shift=3.0, intensity=0.3):
    """The volumes of ``write_reg_corpus`` and their labels, in its order,
    drawn one at a time."""
    rng = np.random.RandomState(seed)
    # coordinates as fractions of each side, so that a cut-down shape (the
    # tests') has the same picture
    frac = np.meshgrid(*[np.arange(n, dtype=np.float32) / n for n in shape],
                       indexing="ij")
    waves = [(rng.uniform(5, 10, 3) * rng.choice([-1, 1], 3),
              rng.uniform(0, 2 * np.pi)) for _ in range(4)]
    while True:
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
        yield np.clip(img, 0, 1), seg


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
    # one validation, whose image summaries run the forward once more
    want = {k: TRAIN_STEPS * REG_STEP_LAUNCHES[k]
            + n_eval * REG_EVAL_LAUNCHES[k] + SUMMARY_LAUNCHES[k]
            for k in REG_STEP_LAUNCHES}
    images, events = written_images(os.path.join(workdir, "logs"))
    cli_lines = out.getvalue().splitlines()
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
         "launches_per_validation_summary": SUMMARY_LAUNCHES,
         "images": images, "tensorboard_event_files": events,
         "summary_lines": [ln for ln in cli_lines if "image summary" in ln],
         "cli_tail": cli_lines[-6:]})
    check_images("reg", images, [f"validation/{k}" for k in (
        "images", "disp_field", "masks", "deform_grid")], cli_lines)
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
    # the evaluations include the seg summary's; the reg summary's forward
    # runs outside the eval step
    want = add_launches(*[r["expected"] for r in rec.steps],
                        *[EVAL_LAUNCHES if phase == "seg" else
                          REG_EVAL_LAUNCHES for phase, _ in rec.evals],
                        SUMMARY_LAUNCHES)
    images, events = written_images(os.path.join(workdir, "logs"))
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
         "images": images, "tensorboard_event_files": events,
         "summary_lines": [ln for ln in cli_lines if "image summary" in ln],
         "cli_tail": cli_lines[-4:]})
    check_images("joint", images, [f"validation_reg/{k}" for k in (
        "images", "disp_field", "masks", "deform_grid")]
        + ["validation_seg/summary"], cli_lines)
    # 2 validation and 2 test volumes, and the validation's seg summary
    if len(seg_steps) != JOINT_ITERATIONS // 2 \
            or len(reg_steps) != JOINT_ITERATIONS // 2 \
            or [p for p, _ in rec.evals].count("seg") != 5 \
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

    checks, splits, reg_attribution = {}, {}, {}
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
            _, g_k2 = step_gradients_of(reg_step, reg_state, seg_state, args)
            with plain_math():
                m_p, g_p = step_gradients_of(reg_step, reg_state, seg_state,
                                             args)
            rerun_max, rerun_mean = grad_agreement(g_k2, g_k)
            checks[f"{state_name}_reg_substituted_{substituted}"] = dict(
                metric_errors(m_k, m_p), **agreement("reg", dtype, g_k, g_p),
                rerun_worst_max_rel=rerun_max,
                rerun_worst_mean_rel=rerun_mean)
            if profile:
                # which kernel's rounding moves the worst entry: the same
                # step with one kernel at a time on its plain version
                launched = joint_reg_launches(substituted)
                one_plain = {}
                for name in PLAIN_OF:
                    if not launched[name]:
                        continue
                    with plain_math([name]):
                        _, g_1 = step_gradients_of(reg_step, reg_state,
                                                   seg_state, args)
                    worst_max, worst_mean = grad_agreement(g_k, g_1)
                    one_plain[name] = {"worst_max_rel": worst_max,
                                       "worst_mean_rel": worst_mean}
                    del g_1
                reg_attribution[f"substituted_{substituted}"] = one_plain
                splits[f"reg_substituted_{substituted}"] = profiled(
                    lambda: step_gradients_of(reg_step, reg_state, seg_state,
                                              args))
            del g_k, g_k2, g_p
        del seg_state, reg_state, seg_model, reg_model
        torch.cuda.empty_cache()
    log({"phase": "joint_check", "gradients_vs_plain": checks,
         "states": "initial_float32: the CLI's seeded draw of both nets, "
                   "every tensor float32; trained_bfloat16: its "
                   "checkpoint, as the CLI runs",
         "untrained_disp_overflow": untrained_overflow,
         "rerun": "rerun_* : the same seg or reg step twice through the "
                  "kernels, relative to each tensor's largest entry; G and "
                  "the anatomy dice's per-class sums add in 64-bit fixed "
                  "point and H, I, J have no atomics, so 0.0 unless another "
                  "op of the step changes its bits between runs; the reg "
                  "step must read 0.0",
         "reg_attribution": reg_attribution,
         "reg_attribution_note": "the trained bf16 reg step with one "
                                 "kernel at a time on its plain version, "
                                 "against the step through every kernel: "
                                 "which kernel's rounding moves the worst "
                                 "entry of the check against the plain "
                                 "versions",
         "step_split": splits})
    bad = [k for k, v in checks.items()
           if not (v["grads_ok"] and v["metrics_ok"])
           or ("_reg_" in k and v["rerun_worst_max_rel"][0] != 0.0)]
    if bad:
        raise AssertionError(f"joint steps disagree: "
                             f"{ {k: checks[k] for k in bad} }")
    return counts


def check_native():
    """Phase native: the native I/O library builds from ``native/`` (g++,
    zlib) and reads a small volume and its labels as the Python parser
    does, bit for bit; the run fails where it is not available."""
    from deepatlas_torch.data import (_native, read_counts, read_nifti,
                                      reset_read_counts, write_nifti)

    t0 = time.perf_counter()
    ok = _native.available()
    record = {"phase": "native", "available": ok,
              "build_s": _native.build_seconds,
              "seconds": time.perf_counter() - t0,
              "library": os.path.relpath(_native.lib_path(), REPO),
              "build_error": _native.build_error}
    if ok:
        rng = np.random.RandomState(7)
        same = []
        reset_read_counts()
        with tempfile.TemporaryDirectory() as tmp:
            for name, data in (
                    ("img.nii.gz", rng.rand(11, 13, 17).astype(np.float32)),
                    ("seg.nii.gz", rng.randint(0, 32, (11, 13, 17)).astype(
                        np.uint8))):
                path = os.path.join(tmp, name)
                write_nifti(path, data)
                got = read_nifti(path).data
                ref = read_nifti(path, prefer_native=False).data
                same.append(bool(np.array_equal(got, ref.astype(np.float32))))
        record.update(same_as_python_parser=same, reads=read_counts())
        ok = all(same) and record["reads"] == {"native": 2, "fallback": 0}
    log(record)
    if not ok:
        raise AssertionError(f"native I/O tier: {record}")


def run_unet_serving_path(seed, workdir):
    """Phase unet_serving: ``infer_seg_torch.main --model UNet`` on one
    synthetic 160x384x384 OAI volume at the documented setting (tile 128^3,
    overlap 16, tile batch 4, bf16, 5 classes) with a seeded checkpoint of
    the fixed UNet: its launches per tile batch (14 k3 convs, 3 transposed
    convs, 1 head, as UNet_light), finite Dice, seconds per volume, and one
    tile batch's logits through the kernels against the plain versions."""
    import torch

    import infer_seg_torch
    from deepatlas_torch.data import Partition, read_nifti
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import save_checkpoint

    names = write_corpus(workdir, seed + 5, n_volumes=1)
    model = get_network("UNet")(in_channel=1, n_classes=N_CLASSES, bias=True,
                                BN=True, dtype=torch.bfloat16)
    sd = seeded_state(model, seed + 5)
    ckpt = save_checkpoint({"epoch": 0, "best_score": 0.0, "model": sd},
                           True, os.path.join(workdir, "ckpt"))
    argv = ["--ckpt", os.path.join(os.path.dirname(ckpt), "model_best"),
            "--data-root", workdir, "--list-file",
            os.path.join(workdir, "test.txt"), "--data", "OAI",
            "--model", "UNet", "--n-classes", str(N_CLASSES),
            "--tile-size", *[str(TILE)] * 3, "--overlap", "16", "16", "16",
            "--tile-batch", str(TILE_BATCH), "--device", "cuda"]
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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
    if [ln["name"] for ln in per_volume] != names \
            or len(per_volume[0]["dice"]) != N_CLASSES - 1 \
            or not np.all(np.isfinite(per_volume[0]["dice"])):
        raise AssertionError(f"unexpected CLI output: {out.getvalue()!r}")
    eff = TILE - 2 * 16
    n_tiles = int(np.prod([-(-s // eff) for s in OAI_SHAPE]))
    batches = -(-n_tiles // TILE_BATCH)
    want = {k: v * batches for k, v in EVAL_LAUNCHES.items()}

    model.load_state_dict(sd)
    model.to("cuda").eval()
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
                        "rel_tol": NET_TOL[dname],
                        "ok": err <= NET_TOL[dname] * scale}
    log({"phase": "unet_serving", "model": "UNet", "volume_shape": OAI_SHAPE,
         "tiles_per_volume": n_tiles, "tile_batches": batches,
         "launches": counts, "launches_expected": want,
         "seconds_per_volume": infer_s, "tiles_per_s": n_tiles / infer_s,
         "max_memory_allocated": peak,
         "tile_batch_forward_ms_bf16": fwd_ms, "logits_vs_plain": agree,
         "cli_lines": lines})
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not all(a["ok"] for a in agree.values()):
        raise AssertionError(f"UNet logits disagree: {agree}")
    return counts


# the fixed UNet's seg training run: a handful of steps of the MindBoggle
# recipe with "model": "UNet"; the loss must fall from the first
# UNET_TRAIN_WINDOW steps to the last
UNET_TRAIN_STEPS = 16
UNET_TRAIN_WINDOW = 5


def run_unet_train_path(seed, workdir):
    """Phase unet_train: the seg experiment with ``"model": "UNet"`` (bias,
    BatchNorm, 32 classes, bf16, batch 1, 168x200x168 crops of the
    synthetic MindBoggle corpus), ``UNET_TRAIN_STEPS`` steps and one
    validation: per step 27 k3 convs, 14 weight gradients, 3 transposed
    convs and 2 head convs, a finite, falling loss; the step's median
    seconds, its peak memory and kernel D's partial sums; then one step's
    gradients through the kernels against the plain versions."""
    import torch

    import train_seg_torch
    from deepatlas_torch.data import (Compose, CropVolume, VolumeToArray,
                                      get_seg_dataset)
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import (SegmentationExperiment,
                                       load_checkpoint, segmentation)

    names = write_mindboggle_corpus(workdir, seed + 6)
    config = train_seg_torch.build_config(train_seg_torch.parse_args(
        ["--data-root", workdir, "--log-root", "logs", "--num-samples", "21",
         "--num-epochs", "1", "--device", "cuda"]))
    config["model"] = "UNet"
    config["samples_per_epoch"] = UNET_TRAIN_STEPS
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
        exp = SegmentationExperiment(config)
        exp.train()
        ckpt = os.path.abspath(os.path.join(exp.ckpoint_dir, "checkpoint"))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n_eval = len(rec.eval_launches)
    want = {k: UNET_TRAIN_STEPS * STEP_LAUNCHES[k] + n_eval * EVAL_LAUNCHES[k]
            for k in STEP_LAUNCHES}
    wgrad_shapes = [(size, cin, cout) for (_, kernel, _, _, size, cin, cout)
                    in unet_cases("unet_training", 1, TRAIN_SHAPE,
                                  TRAIN_CLASSES, True, model="UNet")
                    if kernel == "conv3d_k3_wgrad"]
    partial = [wgrad_partial_bytes("bfloat16", 1, *shape)
               for shape in wgrad_shapes]
    warm = sorted(rec.seconds[2:])
    first, last = (float(np.mean(rec.losses[:UNET_TRAIN_WINDOW])),
                   float(np.mean(rec.losses[-UNET_TRAIN_WINDOW:])))
    log({"phase": "unet_train", "model": "UNet", "train_shape": TRAIN_SHAPE,
         "n_classes": TRAIN_CLASSES, "steps": len(rec.losses),
         "evaluated_volumes": n_eval, "launches": counts,
         "launches_expected": want, "launches_per_step": STEP_LAUNCHES,
         "losses": rec.losses, "loss_first_mean": first,
         "loss_last_mean": last, "first_steps_s": rec.seconds[:2],
         "step_s_median": warm[len(warm) // 2], "step_s_min": warm[0],
         "step_s_max": warm[-1],
         "volumes_per_s_in_steps": 1.0 / (sum(warm) / len(warm)),
         "volumes_per_s_with_loading": len(rec.losses)
         / (rec.last_end - rec.first_start),
         "max_memory_allocated": peak,
         "wgrad_partial_bytes_max": max(partial),
         "wgrad_partial_bytes_per_step": sum(partial),
         "experiment_s": total_s,
         "cli_tail": out.getvalue().splitlines()[-4:]})
    if len(rec.losses) != UNET_TRAIN_STEPS or n_eval != 1:
        raise AssertionError(f"{len(rec.losses)} steps and {n_eval} "
                             f"evaluated volumes, expected "
                             f"{UNET_TRAIN_STEPS}, 1")
    for i, got in enumerate(rec.step_launches):
        if got != STEP_LAUNCHES:
            raise AssertionError(f"step {i} launched {got}, expected "
                                 f"{STEP_LAUNCHES}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not np.all(np.isfinite(rec.losses)) or not last < first:
        raise AssertionError(f"the loss is not finite and falling: "
                             f"{rec.losses}")

    # one more step by hand on the trained state, through the kernels and
    # on the plain versions
    mb = os.path.join(workdir, "mindboggle")
    dataset = get_seg_dataset("MindBoggle")(
        os.path.join(mb, "MMRR-21-flip.txt"), mb, pre_transform=Compose(
            [VolumeToArray(), CropVolume(MB_CROP)]))
    sample = dataset[0]
    x = torch.from_numpy(np.ascontiguousarray(sample["image"])[None]).cuda()
    y = torch.from_numpy(np.ascontiguousarray(
        sample["segmentation"])[None]).cuda()
    model = get_network("UNet")(in_channel=1, n_classes=TRAIN_CLASSES,
                                bias=True, BN=True, dtype=torch.bfloat16)
    model.load_state_dict(load_checkpoint(ckpt)["model"])
    model.cuda()
    criterion = get_loss_function("dice")(**config["loss_settings"])
    agree = seg_gradient_agreement(model, criterion, x, y)
    log({"phase": "unet_train_check", "gradients_vs_plain": agree,
         "volume": names[0],
         "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if not all(a["ok"] for a in agree.values()):
        raise AssertionError(f"UNet step gradients disagree: {agree}")
    return counts


class TimedSampler:
    """Wraps a crop sampler to record, per call, its target class and its
    host seconds."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.calls = []

    def __call__(self, sample):
        t0 = time.perf_counter()
        out = self.sampler(sample)
        self.calls.append((out.get("class"), time.perf_counter() - t0))
        return out


class AugmentRecorder:
    """Wraps ``make_augmenter`` to record, per augmented batch, the kernels
    it launched and its seconds (synchronised)."""

    def __init__(self):
        self.launches, self.seconds = [], []

    def factory(self, make):
        from deepatlas_torch.kernels import launch_counts

        def wrapped(config):
            augmenter = make(config)
            if augmenter is None:
                return None

            def recorded(key, images, segs=None):
                import torch

                before = launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = augmenter(key, images, segs)
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                self.launches.append({k: v - before[k]
                                      for k, v in launch_counts().items()})
                return out

            return recorded

        return wrapped


def augmenter_split(seed):
    """The augmenter's device ms per ``PATCH_BATCH`` x 128^3 batch, queued
    (``cuda_ms(queued=True)``), split into its B-spline field and rigid
    grid, kernel E's two image warps, the two label warps and the blur;
    and one batch through the kernels against the same batch and draws
    with E on its plain version (``max_abs_err``, ``labels_equal``)."""
    import torch

    from deepatlas_torch import kernels
    from deepatlas_torch.data import augment
    from deepatlas_torch.ops import warp_labels

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    images = torch.rand((PATCH_BATCH,) + PATCH + (1,), generator=gen,
                        device="cuda")
    segs = torch.randint(0, N_CLASSES, (PATCH_BATCH,) + PATCH,
                         generator=gen, device="cuda").to(torch.uint8)
    aug = augment.make_augmenter(PATCH_AUGMENTATION)
    draws = aug.draw((seed, 2 ** 20 + 1), PATCH_BATCH)
    # every draw applied, so that each piece does its work
    draws = {k: v[:-1] + (torch.ones(PATCH_BATCH, dtype=torch.bool),)
             for k, v in draws.items()}
    dev = {k: tuple(t.cuda() for t in v) for k, v in draws.items()}
    args = aug.bspline_args

    def fields():
        return (augment.bspline_deform(*dev["bspline"], PATCH,
                                       args["mesh_size"], args["order"]),
                augment.rigid_deform(*dev["rigid"], PATCH))

    grids = fields()
    split = {
        "field_ms": cuda_ms(fields, reps=5, queued=True),
        "warp_kernel_ms": cuda_ms(lambda: [kernels.grid_sample(
            images, g, max_disp=None) for g in grids], reps=5, queued=True),
        "label_warp_ms": cuda_ms(lambda: [warp_labels(segs, g)
                                          for g in grids], reps=5,
                                 queued=True),
        "blur_ms": cuda_ms(lambda: torch.where(
            dev["blur"][0].view(-1, 1, 1, 1, 1),
            augment.gaussian_blur(images, aug.sigma), images), reps=5,
            queued=True),
        "total_ms": cuda_ms(lambda: aug.apply(draws, images, segs), reps=5,
                            queued=True)}
    got_img, got_seg = aug.apply(draws, images, segs)
    with plain_math(["warp_trilinear"]):
        ref_img, ref_seg = aug.apply(draws, images, segs)
    torch.cuda.synchronize()
    err = (got_img - ref_img).abs().max().item()
    scale = ref_img.abs().max().item()
    tol = WARP_TOL["warp_trilinear"]["float32"]
    check = {"max_abs_err": err, "max_abs_ref": scale, "rel_tol": tol,
             "labels_equal": bool(torch.equal(got_seg, ref_seg)),
             "ok": bool(np.isfinite(err)) and err <= tol * scale
             and bool(torch.equal(got_seg, ref_seg))}
    del images, segs, grids, got_img, ref_img, got_seg, ref_seg
    torch.cuda.empty_cache()
    return split, check


def run_oai_patch_path(seed, workdir):
    """Phase oai_patch_training: the seg experiment with the seg CLI's
    config and the JAX experiment's patch keys -- OAI data (3 synthetic
    160x384x384 volumes: 2 for training, 1 for validation, preloaded),
    UNet_light with 5 classes in bf16, ``PATCH_BATCH`` balanced 128^3
    patches a step (threshold 0.01), ``PATCH_AUGMENTATION``,
    ``PATCH_STEPS`` steps and one validation on the whole validation
    volume, so one training and one validation summary.  Per step the
    UNet_light step's 27 / 14 / 3 / 2 launches and the augmenter's 2 of E,
    1 evaluation; finite losses; the step's median seconds, the patch rate
    in the steps and with loading, peak memory; the balanced sampler's host
    ms per crop by target class; the augmenter's device ms by piece; one
    augmented batch through E against its plain version; the image
    summaries written."""
    import torch

    import train_seg_torch
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    from deepatlas_torch.train import SegmentationExperiment, segmentation

    t0 = time.perf_counter()
    names = write_corpus(workdir, seed + 11, n_volumes=N_PATCH_VOLUMES)
    for list_name, part in (("train.txt", names[:-1]),
                            ("valid.txt", names[-1:])):
        with open(os.path.join(workdir, list_name), "w") as f:
            f.write("\n".join(part) + "\n")
    setup_s = time.perf_counter() - t0

    config = train_seg_torch.build_config(train_seg_torch.parse_args(
        ["--data-root", workdir, "--log-root", "logs", "--num-samples", "21",
         "--num-epochs", "1", "--preload", "--device", "cuda"]))
    config.update(
        data="OAI", n_classes=N_CLASSES,
        class_name={k: str(k) for k in range(1, N_CLASSES)},
        model_settings=dict(config["model_settings"], n_classes=N_CLASSES),
        loss_settings=dict(config["loss_settings"], n_class=N_CLASSES),
        crop_size=None, batch_size=PATCH_BATCH,
        samples_per_epoch=PATCH_STEPS * PATCH_BATCH, print_batch_period=4,
        patch_size=list(PATCH), sampler="balanced", patch_threshold=0.01,
        augmentation=PATCH_AUGMENTATION, data_dir=workdir,
        valid_data_dir=workdir,
        training_list_file=os.path.join(workdir, "train.txt"),
        validation_list_file=os.path.join(workdir, "valid.txt"),
        testing_list_file=os.path.join(workdir, "valid.txt"))
    rec = StepRecorder()
    aug_rec = AugmentRecorder()
    samplers = []
    make_sampler = segmentation.SegmentationExperiment._patch_sampler

    def timed_sampler(self):
        samplers.append(TimedSampler(make_sampler(self)))
        return samplers[-1]

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
                                  segmentation.make_seg_eval_step)), \
            mock.patch.object(segmentation, "make_augmenter",
                              aug_rec.factory(segmentation.make_augmenter)), \
            mock.patch.object(segmentation.SegmentationExperiment,
                              "_patch_sampler", timed_sampler):
        exp = SegmentationExperiment(config)
        exp.train()
        log_root = os.path.abspath(exp.ckpoint_dir)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    images, events = written_images(log_root)
    imports = optional_imports()
    split, check = augmenter_split(seed)

    n_eval = len(rec.eval_launches)
    want = add_launches(*[PATCH_STEP_LAUNCHES] * PATCH_STEPS,
                        *[EVAL_LAUNCHES] * n_eval)
    crops = samplers[0].calls if samplers else []
    by_class = {}
    for cls, sec in crops:
        by_class.setdefault(str(cls), []).append(sec * 1e3)
    warm = sorted(rec.seconds[2:])
    cli_lines = out.getvalue().splitlines()
    # where the wall clock of the training loop goes (from the first step's
    # start to the last one's end): the steps, the augmenter (synchronised;
    # the first batch's is before the first step), the wait for the loader
    # (the first batch's included), and the rest (the host-to-device
    # copies and the loop's own Python)
    loader = exp.training_data_loader
    wall = rec.last_end - rec.first_start
    split_s = {"wall": wall, "steps": sum(rec.seconds),
               "augmenter": sum(aug_rec.seconds[1:]),
               "loader_wait": loader.wait_seconds}
    split_s["rest"] = wall - sum(v for k, v in split_s.items()
                                 if k != "wall")
    log({"phase": "oai_patch_training", "volume_shape": OAI_SHAPE,
         "patch": PATCH, "batch": PATCH_BATCH, "n_classes": N_CLASSES,
         "augmentation": PATCH_AUGMENTATION, "steps": len(rec.losses),
         "evaluated_volumes": n_eval, "launches": counts,
         "launches_expected": want,
         "launches_per_step": STEP_LAUNCHES,
         "launches_per_augmented_batch": AUGMENT_LAUNCHES,
         "augmenter_launches": aug_rec.launches, "losses": rec.losses,
         "first_steps_s": rec.seconds[:2],
         "step_s_median": warm[len(warm) // 2], "step_s_min": warm[0],
         "step_s_max": warm[-1],
         "patches_per_s_in_steps": PATCH_BATCH / (sum(warm) / len(warm)),
         "patches_per_s_with_loading": PATCH_BATCH * len(rec.losses)
         / (rec.last_end - rec.first_start),
         "max_memory_allocated": peak,
         "loop_split_s": split_s,
         "augmenter_s_median": sorted(aug_rec.seconds)[PATCH_STEPS // 2],
         "augmenter_device_ms": split, "augment_check": check,
         "crops": len(crops), "crop_host_ms_by_class": {
             k: {"n": len(v), "mean": float(np.mean(v)),
                 "max": float(np.max(v))} for k, v in sorted(by_class.items())},
         "crop_host_ms_mean": float(np.mean([c[1] for c in crops]) * 1e3)
         if crops else None,
         "loader_workers": loader.num_workers,
         "ingest_wait_fraction": loader.wait_fraction,
         "images": images, "tensorboard_event_files": events,
         "imports": imports, "setup_s": setup_s, "experiment_s": total_s,
         "cli_tail": cli_lines[-3:]})
    if len(rec.losses) != PATCH_STEPS or n_eval != 1:
        raise AssertionError(f"{len(rec.losses)} steps and {n_eval} "
                             f"evaluated volumes, expected {PATCH_STEPS}, 1")
    for i, got in enumerate(rec.step_launches):
        if got != STEP_LAUNCHES:
            raise AssertionError(f"step {i} launched {got}, expected "
                                 f"{STEP_LAUNCHES}")
    if aug_rec.launches != [AUGMENT_LAUNCHES] * PATCH_STEPS:
        raise AssertionError(f"the augmenter launched {aug_rec.launches}, "
                             f"expected {AUGMENT_LAUNCHES} a batch")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if not np.all(np.isfinite(rec.losses)):
        raise AssertionError(f"non-finite losses {rec.losses}")
    if not check["ok"]:
        raise AssertionError(f"the augmented batch through kernel E differs "
                             f"from its plain version: {check}")
    # the loader's threads share the sampler, whose target class advances
    # without a lock (as in the JAX package): two threads may draw the same
    # class and skip the next, so only the range of the classes is held
    if len(crops) < PATCH_STEPS * PATCH_BATCH \
            or not {c for c, _ in crops} <= set(range(N_CLASSES + 1)):
        raise AssertionError(f"the balanced sampler's crops: {by_class}")
    check_images("oai_patch_training", images, ("training", "validation"),
                 cli_lines)
    if imports["tensorboard"] != (events > 0):
        raise AssertionError(f"tensorboard imports {imports['tensorboard']}"
                             f" but {events} event files")
    return counts

# ------------------------------------------------------------ parallel tiers

# the parallel phase: PAR_RANKS processes on the one card over gloo (NCCL
# refuses two ranks on one GPU), then the data-parallel CLI at a world of
# one over NCCL through torchrun
PAR_RANKS = 2
# the spatial paths' depth: the recipes' 168 does not split into 2 shards
# that UNet_light's 3 pools (a multiple of 8 a shard) and VoxelMorph's 4
# strided convs (an even depth at every level: a multiple of 16 a shard)
# divide; 160 (80 a shard) is the nearest depth both take.  The OAI volume's
# 160 splits as it is.
PAR_DEPTH = 160
PAR_SHAPE = (PAR_DEPTH,) + TRAIN_SHAPE[1:]
PAR_SHARD = (PAR_DEPTH // PAR_RANKS,) + TRAIN_SHAPE[1:]
SERVE_SHARD = (OAI_SHAPE[0] // PAR_RANKS,) + OAI_SHAPE[1:]
PAR_TRAIN_STEPS = 3
# the parallel runs held against one process step with SGD in place of the
# recipes' Adam: the parameters after the steps then compare the gradients
# linearly, where Adam moves an entry whose gradient is rounding noise (the
# BatchNorm scales' near-cancelling sums) by about lr either way
PAR_LR = 1e-2
# the seg recipe's criterion (train_seg_torch.py)
SEG_LOSS_SETTINGS = {"weight_type": "Uniform", "no_bg": False,
                     "softmax": True, "eps": 1e-6}
# the joint recipe's weights (train_deepatlas_torch.py)
JOINT_WEIGHTS = {"reg_weight": 1.0, "anatomy_weight": 3.0,
                 "supervised_weight": 1.0}
# the DP joint batch: rank 0 a fully labelled pair (the hard regime, the
# matched-label warp), rank 1 a pair with an unlabelled moving side
# (f_hard; its reg step substitutes the moving labels)
PAR_JOINT_FLAGS = ((True, False), (True, True))
# the kernels a parallel run launches (the spatial tier's convs on A and D
# at depth padding 0, the shard-local B and C, E and F in the halo'd warp,
# the DP joint steps' G, H and I)
PAR_KERNELS = ("conv3d_k3", "conv3d_k3_wgrad", "deconv2x", "conv3d_point",
               "warp_trilinear", "warp_grid_grad", "splat_trilinear",
               "matched_warp", "matched_warp_fused")
# the NCCL check's corpus: the recipe's crop leaves 72x72x64 of it (full
# width, 32 classes, the recipe's 42 steps; the size keeps it a few seconds)
NCCL_SHAPE = (86, 90, 78)


def parallel_cases():
    """Rank 0's launches of kernels A (``conv3d_k3``: roles ``forward_p0``,
    ``dx_p0``, their ``_s2`` forms, and ``serve_p0``, a bfloat16 serving
    forward) and D (``wgrad_p0``) at depth padding 0 in one unit of the
    parallel path: a spatial UNet_light training step on an 80x200x168
    shard (32 classes), a spatial VoxelMorph step on the same shard, and
    the spatial serving forward of an 80x384x384 OAI shard.  The size is
    the shard's, the kernel's input carries one more plane on each side.
    B and C, shard-local, run at the shapes of the other paths."""
    cases = {}

    def p0(src, role_of):
        for (_, kernel, role, batch, size, cin, cout), n in src.items():
            if kernel in ("conv3d_k3", "conv3d_k3_wgrad") and role_of(role):
                key = ("parallel", kernel, role_of(role), batch, size, cin,
                       cout)
                cases[key] = cases.get(key, 0) + n

    p0(unet_cases("parallel", 1, PAR_SHARD, TRAIN_CLASSES, True),
       lambda r: r + "_p0")
    p0(voxelmorph_cases("parallel", 1, PAR_SHARD), lambda r: r + "_p0")
    p0(unet_cases("parallel", 1, SERVE_SHARD, N_CLASSES, False),
       lambda r: "serve_p0" if r == "forward" else None)
    return cases


def _par_data(shape, seed, n_classes=TRAIN_CLASSES, batch=1, scale=1.0):
    """A seeded ``(batch, *shape, 1)`` image in [0, scale) and labels
    that follow its intensity, on the host (each rank makes the whole batch
    and keeps its block, as the loaders do)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((batch,) + tuple(shape) + (1,), generator=gen)
    labels = (img[..., 0] * n_classes).long().clamp(max=n_classes - 1)
    return img * scale, labels


def _par_seg_model(seed, n_classes=TRAIN_CLASSES, bf16=True):
    import torch

    from deepatlas_torch.models import get_network
    model = get_network("UNet_light")(in_channel=1, n_classes=n_classes,
                                      bias=True, BN=True,
                                      dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(seeded_state(model, seed))
    return model.cuda()


def _par_reg_model(seed):
    import torch

    from deepatlas_torch.models import get_network
    model = get_network("voxel_morph_cvpr")(dtype=torch.bfloat16,
                                            max_disp=REG_MAX_DISP)
    model.load_state_dict(seeded_state(model, seed + 1))
    return model.cuda()


def _par_optimizer(model):
    import torch
    return torch.optim.SGD(model.parameters(), lr=PAR_LR)


def _grads_cpu(model):
    """A float32 host copy of ``model``'s parameter gradients (the last
    step's, which a step leaves in place)."""
    return {k: p.grad.detach().float().cpu().clone()
            for k, p in model.named_parameters()}


def _state_cpu(model):
    """A float32 host copy of ``model``'s state."""
    return {k: v.detach().float().cpu().clone() for k, v in
            model.state_dict().items()}


def _par_serve(rank, workdir, seed):
    import infer_seg_torch

    argv = ["--ckpt", os.path.join(workdir, "ckpt", "model_best"),
            "--data-root", workdir, "--list-file",
            os.path.join(workdir, "test.txt"), "--data", "OAI",
            "--n-classes", str(N_CLASSES), "--spatial-shards",
            str(PAR_RANKS), "--dist-backend", "gloo", "--device", "cuda",
            "--out-dir", os.path.join(workdir, "preds")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer_seg_torch.main(argv)
    return out.getvalue()


def _par_spatial_train(rank, workdir, seed, bf16=True,
                       steps=PAR_TRAIN_STEPS):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_mesh, make_spatial_seg_step,
                                          replicate, shard_volume_batch)
    from deepatlas_torch.train import TrainState
    mesh = make_mesh(space=PAR_RANKS, device="cuda")
    model = replicate(_par_seg_model(seed, bf16=bf16), mesh)
    state = TrainState(model, _par_optimizer(model))
    step = make_spatial_seg_step(model, get_loss_function("dice"),
                                 TRAIN_CLASSES, mesh,
                                 criterion_kwargs=SEG_LOSS_SETTINGS)
    img, labels = _par_data(PAR_SHAPE, seed)
    x, y = (t.cuda() for t in shard_volume_batch((img, labels), mesh))
    losses, times, grads = [], [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss, _ = step(state, x, y)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        grads = grads or _grads_cpu(model)
    return {"losses": losses, "step_s": times, "grads": grads,
            "state": _state_cpu(model)}


def _reg_pair(shape, seed):
    """A moving image and the same image shifted by a voxel on each axis,
    at the reg corpus's 0.3 intensity scale."""
    import torch

    img, _ = _par_data(shape, seed, scale=0.3)
    return img, torch.roll(img, (1, 1, 1), dims=(1, 2, 3))


def _par_spatial_reg(rank, workdir, seed):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_mesh, make_spatial_reg_step,
                                          replicate, shard_volume_batch)
    from deepatlas_torch.train import TrainState
    mesh = make_mesh(space=PAR_RANKS, device="cuda")
    model = replicate(_par_reg_model(seed), mesh)
    state = TrainState(model, _par_optimizer(model))
    step = make_spatial_reg_step(model, get_loss_function("lncc"),
                                 get_loss_function("bendingEnergy"), 1.0,
                                 mesh, sim_kwargs={"filter_size": 9})
    moving, fixed = (t.cuda() for t in shard_volume_batch(
        _reg_pair(PAR_SHAPE, seed), mesh))
    t0 = time.perf_counter()
    state, metrics = step(state, moving, fixed)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "step_s": time.perf_counter() - t0, "grads": _grads_cpu(model),
            "state": _state_cpu(model)}


def _par_dp_seg(rank, workdir, seed):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_dp_seg_train_step, make_mesh,
                                          replicate, shard_batch)
    from deepatlas_torch.train import TrainState
    mesh = make_mesh(data=PAR_RANKS, device="cuda")
    model = replicate(_par_seg_model(seed), mesh)
    state = TrainState(model, _par_optimizer(model))
    step = make_dp_seg_train_step(get_loss_function("dice")(
        n_class=TRAIN_CLASSES, **SEG_LOSS_SETTINGS), mesh)
    x, y = (t.cuda() for t in shard_batch(
        _par_data(TRAIN_SHAPE, seed, batch=PAR_RANKS), mesh))
    t0 = time.perf_counter()
    state, loss, _ = step(state, x, y)
    return {"loss": float(loss), "step_s": time.perf_counter() - t0,
            "grads": _grads_cpu(model), "state": _state_cpu(model)}


def _par_dp_joint(rank, workdir, seed):
    import torch

    from deepatlas_torch.kernels import grid_sample
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.parallel import (make_dp_joint_steps, make_mesh,
                                          replicate, shard_batch)
    from deepatlas_torch.train import TrainState, make_optimizer
    from deepatlas_torch.train.deepatlas import ANATOMY_DTYPE
    mesh = make_mesh(data=PAR_RANKS, device="cuda")
    seg = replicate(_par_seg_model(seed), mesh)
    reg = replicate(_par_reg_model(seed), mesh)
    seg_state = TrainState(seg, make_optimizer(seg, 1e-3))
    reg_state = TrainState(reg, make_optimizer(reg, 1e-3))
    reg_step, seg_step = make_dp_joint_steps(
        get_loss_function("lncc")(filter_size=9),
        get_loss_function("bendingEnergy")(),
        get_loss_function("dice")(n_class=TRAIN_CLASSES,
                                  **SEG_LOSS_SETTINGS),
        JOINT_WEIGHTS["reg_weight"], JOINT_WEIGHTS["anatomy_weight"],
        JOINT_WEIGHTS["supervised_weight"], TRAIN_CLASSES, mesh,
        warp_fn=functools.partial(grid_sample, max_disp=REG_MAX_DISP),
        seg_warp_fn=functools.partial(grid_sample, max_disp=REG_MAX_DISP,
                                      grad="values"),
        anatomy_dtype=ANATOMY_DTYPE, max_disp=REG_MAX_DISP,
        fused_anatomy=True, hard_fused=True)
    moving, fixed = _reg_pair(TRAIN_SHAPE, seed)
    moving, fixed = (torch.cat([t, t.flip(1)]) for t in (moving, fixed))
    _, mseg = _par_data(TRAIN_SHAPE, seed + 2, batch=PAR_RANKS)
    _, fseg = _par_data(TRAIN_SHAPE, seed + 3, batch=PAR_RANKS)
    local = shard_batch((moving, fixed, mseg, fseg), mesh)
    flags = shard_batch(tuple(torch.tensor(f) for f in PAR_JOINT_FLAGS),
                        mesh)
    args = [t.cuda() for t in local] + list(flags)
    t0 = time.perf_counter()
    seg_state, seg_metrics = seg_step(seg_state, reg_state, *args)
    seg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reg_state, reg_metrics = reg_step(reg_state, seg_state, *args)
    return {"seg_metrics": {k: float(v) for k, v in seg_metrics.items()},
            "reg_metrics": {k: float(v) for k, v in reg_metrics.items()},
            "seg_step_s": seg_s, "reg_step_s": time.perf_counter() - t0,
            "seg_state": _state_cpu(seg), "reg_state": _state_cpu(reg)}


PAR_TASKS = (("spatial_serving", _par_serve),
             ("spatial_training", _par_spatial_train),
             # one float32 step, where every parameter is held
             ("spatial_training_f32",
              functools.partial(_par_spatial_train, bf16=False, steps=1)),
             ("spatial_registration", _par_spatial_reg),
             ("dp_seg", _par_dp_seg), ("dp_joint", _par_dp_joint))


def _parallel_rank(rank, workdir, seed):
    """One rank of the parallel phase (spawned ``PAR_RANKS`` times): one
    gloo process group on the card for every task, each task's launches
    counted from 0 and read when it returns, results saved for the
    parent."""
    sys.path.insert(0, REPO)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(PAR_RANKS),
                      LOCAL_RANK="0")
    import torch
    import torch.distributed as dist

    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    from deepatlas_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make_mesh(space=PAR_RANKS, device="cuda", backend="gloo",
              init_method="file://" + os.path.join(workdir, "pg"))
    out = {}
    for name, task in PAR_TASKS:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        result = task(rank, workdir, seed)
        torch.cuda.synchronize()
        out[name] = {"result": result, "launches": launch_counts(),
                     "seconds": time.perf_counter() - t0}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# the relative change of the input that stands for one rounding at a type:
# the spatial checks hold each gradient tensor to 3 times what this change
# does to the single-process step's own gradients (its conditioning), or to
# the train phase's limit where that is larger.  In bfloat16 the input is
# rounded to bf16 first, so its change is half a bf16 step.
COND_EPS = {"float32": 1e-7, "bfloat16": 2.0 ** -9}


def _grad_agreement(got, ref, skip=()):
    """Per tensor, ``got``'s gradient against ``ref``'s: the mean and the
    largest |difference| over the entries, relative to the largest entry of
    ``ref``'s."""
    out = {}
    for k, r in ref.items():
        if k in skip:
            continue
        scale = float(r.abs().max())
        if scale == 0.0:
            continue
        diff = (got[k] - r).abs()
        out[k] = (float(diff.mean()) / scale, float(diff.max()) / scale)
    return out


def _worst(agree, n=6):
    """The ``n`` tensors whose gradients agree least, by the mean."""
    return sorted(([k, *v] for k, v in agree.items()),
                  key=lambda r: -r[1])[:n]


def _hold_grads(part, agree, cond, tol, at):
    """Each tensor's reading ``at`` its mean or its worst entry held to the
    larger of ``tol`` and 3 times its conditioning reading.  Returns the
    worst ratio of reading to limit."""
    i = 0 if at == "mean" else 1
    worst, bad = 0.0, []
    for k, v in agree.items():
        limit = max(tol, 3.0 * cond.get(k, (0.0, 0.0))[i])
        worst = max(worst, v[i] / limit)
        if v[i] > limit:
            bad.append((k, v[i], limit))
    if bad:
        raise AssertionError(f"{part}: gradients differ from the "
                             f"single-process step's ({at} over a tensor, "
                             f"relative to its largest entry) past their "
                             f"limits: {bad[:6]}")
    return worst


def _noise_biases(names):
    """A conv bias in front of a BatchNorm: the batch mean removes it, its
    gradient is rounding noise only (as in the train phase)."""
    return {k for k in names if k.endswith(".bias")
            and k.rsplit(".", 1)[0] + ".bn.weight" in names}


def _max_state_err(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def _single_dp_seg(seed):
    """The data-parallel seg step's function in one process: each
    replica's row forward and backward with its own BatchNorm moments and
    class weights, the gradients, losses and new running statistics
    averaged, one SGD update."""
    import torch

    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models.layers import BatchNorm
    model = _par_seg_model(seed)
    opt = _par_optimizer(model)
    crit = get_loss_function("dice")(n_class=TRAIN_CLASSES,
                                     **SEG_LOSS_SETTINGS)
    img, labels = _par_data(TRAIN_SHAPE, seed, batch=PAR_RANKS)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    start = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    new = [[torch.zeros_like(a), torch.zeros_like(b)] for a, b in start]
    losses = []
    opt.zero_grad(set_to_none=True)
    for r in range(PAR_RANKS):
        for m, (a, b) in zip(bns, start):
            m.running_mean.copy_(a)
            m.running_var.copy_(b)
        logits = model(img[r:r + 1].cuda(), train=True)
        loss = crit(logits.float(), labels[r:r + 1].cuda())
        (loss / PAR_RANKS).backward()
        losses.append(float(loss))
        for m, acc in zip(bns, new):
            acc[0] += m.running_mean / PAR_RANKS
            acc[1] += m.running_var / PAR_RANKS
    for m, (a, b) in zip(bns, new):
        m.running_mean.copy_(a)
        m.running_var.copy_(b)
    opt.step()
    return float(np.mean(losses)), _grads_cpu(model), _state_cpu(model)


def _nccl_cli(workdir):
    """The NCCL check's child, started by torchrun: the data-parallel seg
    CLI at a world of one (``--debug``: a loss line every 2 steps), its
    launch counts, losses and backend written for the parent."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    import train_seg_torch
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = io.StringIO()
    with contextlib.chdir(workdir), contextlib.redirect_stdout(out):
        dice = train_seg_torch.main(
            ["--data-root", workdir, "--log-root", "logs", "--num-samples",
             "21", "--num-epochs", "1", "--device", "cuda",
             "--data-parallel", "--debug"])[1]
    result = {"launches": launch_counts(), "test_dice_avg": float(dice),
              "backend": dist.get_backend() if dist.is_initialized()
              else None,
              "world_size": dist.get_world_size() if dist.is_initialized()
              else None,
              "losses": [float(m) for m in re.findall(
                  r"loss: ([0-9.naninf]+)", out.getvalue())]}
    with open(os.path.join(workdir, "nccl.json"), "w") as f:
        json.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def run_parallel_path(seed, workdir):
    """Phase ``parallel``: the parallel tiers at full width, 2 ranks on the
    one card over gloo (correctness, not scaling: both ranks share the
    H100), against the single-process runs on the card; then the
    data-parallel CLI over NCCL at a world of one under torchrun.  Returns
    the launches of both ranks' runs, summed."""
    import torch
    import torch.multiprocessing as tmp

    from deepatlas_torch.data import read_nifti
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.train import (TrainState, make_reg_train_step,
                                       make_seg_train_step, save_checkpoint)

    t0 = time.perf_counter()
    names = write_corpus(workdir, seed, n_volumes=1)
    serve_model = _par_seg_model(seed, N_CLASSES)
    save_checkpoint({"epoch": 0, "best_score": 0.0,
                     "model": _state_cpu(serve_model)}, True,
                    os.path.join(workdir, "ckpt"))
    del serve_model
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmp.start_processes(_parallel_rank, args=(workdir, seed),
                        nprocs=PAR_RANKS, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(PAR_RANKS)]
    launches = dict(NO_LAUNCHES)
    for rank in ranks:
        for task in rank.values():
            for k, v in task["launches"].items():
                launches[k] += v

    # launches per task against the single-process step tables
    seg_by_regime = {True: "hard", False: "f_hard"}
    want = {
        "spatial_serving": [EVAL_LAUNCHES] * PAR_RANKS,
        "spatial_training": [{k: PAR_TRAIN_STEPS * v for k, v in
                              STEP_LAUNCHES.items()}] * PAR_RANKS,
        "spatial_training_f32": [STEP_LAUNCHES] * PAR_RANKS,
        "spatial_registration": [REG_STEP_LAUNCHES] * PAR_RANKS,
        "dp_seg": [STEP_LAUNCHES] * PAR_RANKS,
        "dp_joint": [add_launches(
            joint_seg_launches(seg_by_regime[PAR_JOINT_FLAGS[0][r]]),
            joint_reg_launches(0 if PAR_JOINT_FLAGS[0][r] else 1))
            for r in range(PAR_RANKS)]}
    for task, tables in want.items():
        for r, table in enumerate(tables):
            got = ranks[r][task]["launches"]
            if got != table:
                raise AssertionError(f"parallel {task} rank {r}: launches "
                                     f"{got} != {table}")

    # spatial serving: rank 0's labels are the single-process forward's
    lines = [json.loads(ln) for ln in
             ranks[0]["spatial_serving"]["result"].splitlines()
             if ln.startswith("{")]
    if ranks[1]["spatial_serving"]["result"].strip():
        raise AssertionError("rank 1 of the serving CLI printed")
    if [ln.get("name") for ln in lines[:-1]] != names or \
            not all(np.all(np.isfinite(ln.get("dice", ln.get(
                "mean_dice_per_class", [np.nan])))) for ln in lines):
        raise AssertionError(f"spatial serving lines {lines}")
    model = _par_seg_model(seed, N_CLASSES).eval()
    served = read_nifti(os.path.join(workdir, "preds",
                                     f"{names[0]}_pred.nii.gz")).data
    image = np.clip(read_nifti(os.path.join(
        workdir, f"{names[0]}_image.nii.gz")).data, 0.0, 1.0)
    with torch.no_grad():
        # the loader's VolumeToArray clamps to [0, 1]
        whole = torch.from_numpy(np.ascontiguousarray(
            image, dtype=np.float32))[None, ..., None]
        t1 = time.perf_counter()
        ref = model(whole.cuda(), train=False).argmax(-1)[0]
        torch.cuda.synchronize()
        single_serve_s = time.perf_counter() - t1
    ref = ref.to(torch.uint8).cpu().numpy()
    serve_equal = bool(np.array_equal(np.asarray(served), ref))
    differ = int((np.asarray(served) != ref).sum())
    del model, whole
    torch.cuda.empty_cache()
    if not serve_equal:
        raise AssertionError(f"spatial serving: {differ} labels differ from "
                             f"the single-process forward")

    # spatial training: the same steps on one process, the same seed; its
    # conditioning: one more step on the input scaled by 1 + COND_EPS
    def single_train(bf16, steps, scale=1.0):
        model = _par_seg_model(seed, bf16=bf16)
        state = TrainState(model, _par_optimizer(model))
        step = make_seg_train_step(get_loss_function("dice")(
            n_class=TRAIN_CLASSES, **SEG_LOSS_SETTINGS))
        img, labels = _par_data(PAR_SHAPE, seed)
        x, y = (img * scale).cuda(), labels.cuda()
        losses, step_s, grads = [], [], None
        for _ in range(steps):
            t1 = time.perf_counter()
            state, loss, _ = step(state, x, y)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t1)
            grads = grads or _grads_cpu(model)
        out = _state_cpu(model)
        del model, state, step, x, y
        torch.cuda.empty_cache()
        return grads, out, losses, step_s

    train_check = {}
    for task, bf16, steps in (("spatial_training", True, PAR_TRAIN_STEPS),
                              ("spatial_training_f32", False, 1)):
        dname = "bfloat16" if bf16 else "float32"
        ref_grads, ref, single_losses, single_step_s = \
            single_train(bf16, steps)
        cond_grads, _, cond_losses, _ = single_train(
            bf16, 1, 1.0 + COND_EPS[dname])
        sp = [r[task]["result"] for r in ranks]
        noise = _noise_biases(ref_grads)
        agree = _grad_agreement(sp[0]["grads"], ref_grads, noise)
        cond = _grad_agreement(cond_grads, ref_grads, noise)
        # the train phase's rules: bfloat16 in the mean over a tensor,
        # float32 at its worst entry
        if bf16:
            worst = _hold_grads(task, agree, cond,
                                GRAD_TOL["bfloat16_mean"], "mean")
        else:
            worst = _hold_grads(task, agree, cond, GRAD_TOL["float32"],
                                "max")
        loss_err = max(abs(a - b) for a, b in zip(sp[0]["losses"],
                                                  single_losses))
        loss_cond = abs(cond_losses[0] - single_losses[0])
        replicas_equal = all(torch.equal(sp[0]["state"][k],
                                         sp[1]["state"][k]) for k in ref)
        if not (loss_err <= max(STEP_METRIC_TOL, 3.0 * loss_cond)
                and replicas_equal):
            raise AssertionError(f"{task}: losses {sp[0]['losses']} vs "
                                 f"{single_losses} (conditioning "
                                 f"{loss_cond}), replicas equal "
                                 f"{replicas_equal}")
        train_check[task] = {
            "shape": PAR_SHAPE, "shard": PAR_SHARD, "dtype": dname,
            "losses": sp[0]["losses"], "single_losses": single_losses,
            "max_loss_err": loss_err, "loss_conditioning": loss_cond,
            "step_s": sp[0]["step_s"], "single_step_s": single_step_s,
            "grad_err_over_limit_worst": worst,
            "grad_err": _worst(agree), "grad_conditioning": _worst(cond),
            "final_param_max_abs_err": _max_state_err(sp[0]["state"], ref)}

    # spatial registration: one step on one process, and its conditioning
    def single_reg(scale=1.0):
        model = _par_reg_model(seed)
        state = TrainState(model, _par_optimizer(model))
        moving, fixed = (t.cuda() for t in _reg_pair(PAR_SHAPE, seed))
        t1 = time.perf_counter()
        state, metrics = make_reg_train_step(
            get_loss_function("lncc")(filter_size=9),
            get_loss_function("bendingEnergy")(), 1.0)(
                state, moving * scale, fixed)
        step_s = time.perf_counter() - t1
        out = _grads_cpu(model), _state_cpu(model), \
            {k: float(v) for k, v in metrics.items()}, step_s
        del model, state, moving, fixed
        torch.cuda.empty_cache()
        return out

    reg_grads, reg_ref, ref_metrics, single_reg_s = single_reg()
    cond_reg_grads, _, cond_metrics, _ = single_reg(
        1.0 + COND_EPS["bfloat16"])
    rg = [r["spatial_registration"]["result"] for r in ranks]
    reg_agree = _grad_agreement(rg[0]["grads"], reg_grads)
    reg_cond = _grad_agreement(cond_reg_grads, reg_grads)
    reg_worst = max(
        _hold_grads("spatial registration", reg_agree, reg_cond,
                    REG_GRAD_TOL["bfloat16_mean"], "mean"),
        _hold_grads("spatial registration", reg_agree, reg_cond,
                    REG_GRAD_TOL["bfloat16_max"], "max"))
    reg_metric_err = max(abs(rg[0]["metrics"][k] - ref_metrics[k])
                         for k in ("loss", "sim", "reg"))
    reg_metric_cond = max(abs(cond_metrics[k] - ref_metrics[k])
                          for k in ("loss", "sim", "reg"))
    if not (reg_metric_err <= max(STEP_METRIC_TOL, 3.0 * reg_metric_cond)
            and all(torch.equal(rg[0]["state"][k], rg[1]["state"][k])
                    for k in reg_ref)):
        raise AssertionError(f"spatial registration: metrics "
                             f"{rg[0]['metrics']} vs {ref_metrics}")

    # data-parallel seg step against its function in one process
    dp_loss, dp_grads, dp_ref = _single_dp_seg(seed)
    dp = [r["dp_seg"]["result"] for r in ranks]
    dp_agree = _grad_agreement(dp[0]["grads"], dp_grads,
                               _noise_biases(dp_grads))
    dp_worst = _hold_grads("dp seg step", dp_agree, {},
                           GRAD_TOL["bfloat16_mean"], "mean")
    dp_stats_err = max(float((dp[0]["state"][k] - dp_ref[k]).abs().max())
                       for k in dp_ref if k.endswith(("running_mean",
                                                      "running_var")))
    if not (abs(dp[0]["loss"] - dp_loss) <= STEP_METRIC_TOL
            and dp_stats_err <= STEP_METRIC_TOL and all(
                torch.equal(dp[0]["state"][k], dp[1]["state"][k])
                for k in dp_ref)):
        raise AssertionError(f"dp seg step: loss {dp[0]['loss']} vs "
                             f"{dp_loss}, BatchNorm statistics "
                             f"{dp_stats_err}")

    # data-parallel joint steps: each rank its own regime, one update
    jt = [r["dp_joint"]["result"] for r in ranks]
    for part in ("seg_state", "reg_state"):
        if not all(torch.equal(jt[0][part][k], jt[1][part][k])
                   for k in jt[0][part]):
            raise AssertionError(f"dp joint: the replicas' {part} differ")
    for part in ("seg_metrics", "reg_metrics"):
        if jt[0][part] != jt[1][part] or not all(
                np.isfinite(v) for v in jt[0][part].values()):
            raise AssertionError(f"dp joint {part}: {jt[0][part]} / "
                                 f"{jt[1][part]}")
    ranks_s_total = ranks_s

    # NCCL: the data-parallel CLI at a world of one, started by torchrun
    nccl_dir = os.path.join(workdir, "nccl")
    os.makedirs(nccl_dir)
    write_mindboggle_corpus(nccl_dir, seed, shape=NCCL_SHAPE)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", os.path.join(REPO, "chip_smoke.py"),
         "--nccl-cli", nccl_dir], capture_output=True, text=True,
        timeout=600)
    nccl_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise AssertionError(f"the NCCL run failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(nccl_dir, "nccl.json")) as f:
        nccl = json.load(f)
    if nccl["backend"] != "nccl" or nccl["world_size"] != 1 or \
            not np.isfinite(nccl["test_dice_avg"]) or not nccl["losses"] \
            or not np.all(np.isfinite(nccl["losses"])):
        raise AssertionError(f"the NCCL run: {nccl}")
    nccl_want = {k: TRAIN_STEPS * STEP_LAUNCHES[k] for k in NO_LAUNCHES}
    for k in ("conv3d_k3", "conv3d_k3_wgrad"):
        if nccl["launches"][k] < nccl_want[k]:
            raise AssertionError(f"the NCCL run launched {k} "
                                 f"{nccl['launches'][k]} times, fewer than "
                                 f"its {TRAIN_STEPS} steps take")
    for k, v in nccl["launches"].items():
        launches[k] += v

    missing = [k for k in PAR_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the parallel paths never launched {missing}")
    log({"phase": "parallel", "ranks": PAR_RANKS, "backend": "gloo",
         "note": "2 ranks share the one H100 over gloo (halo planes staged "
                 "through the host): correctness, not scaling",
         "setup_s": setup_s, "ranks_s": ranks_s_total,
         "task_seconds": {t: [r[t]["seconds"] for r in ranks]
                          for t, _ in PAR_TASKS},
         "launches_by_task": {t: [r[t]["launches"] for r in ranks]
                              for t, _ in PAR_TASKS},
         "spatial_serving": {"volume": OAI_SHAPE, "cli_lines": lines,
                             "labels_equal_single_process": serve_equal,
                             "single_process_forward_s": single_serve_s},
         **train_check,
         "spatial_registration": {"metrics": rg[0]["metrics"],
                                  "single_metrics": ref_metrics,
                                  "max_metric_err": reg_metric_err,
                                  "metric_conditioning": reg_metric_cond,
                                  "step_s": rg[0]["step_s"],
                                  "single_step_s": single_reg_s,
                                  "grad_err_over_limit_worst": reg_worst,
                                  "grad_err": _worst(reg_agree),
                                  "grad_conditioning": _worst(reg_cond),
                                  "final_param_max_abs_err": _max_state_err(
                                      rg[0]["state"], reg_ref)},
         "dp_seg": {"loss": dp[0]["loss"], "single_loss": dp_loss,
                    "step_s": [d["step_s"] for d in dp],
                    "bn_stats_max_err": dp_stats_err,
                    "grad_err_over_limit_worst": dp_worst,
                    "grad_err": _worst(dp_agree),
                    "final_param_max_abs_err": _max_state_err(
                        dp[0]["state"], dp_ref)},
         "dp_joint": {"flags": PAR_JOINT_FLAGS,
                      "seg_metrics": jt[0]["seg_metrics"],
                      "reg_metrics": jt[0]["reg_metrics"],
                      "seg_step_s": [j["seg_step_s"] for j in jt],
                      "reg_step_s": [j["reg_step_s"] for j in jt]},
         "nccl": dict(nccl, seconds=nccl_s, shape=NCCL_SHAPE),
         "launches": launches})
    return launches


# ------------------------------------------------------- rematerialization

REMAT_STEPS = 8
# steps of each side of the joint seg step and of the fixed UNet at half
# the depth: the median of the warm ones (all but the first)
REMAT_SHORT_STEPS = 4
# the fixed UNet on OAI volumes through the seg experiment: remat on and
# off at half the depth (held bit for bit), the whole depth with remat
REMAT_HALF_DEPTH = OAI_SHAPE[0] // 2
REMAT_WHOLE_DEPTH = OAI_SHAPE[0]
REMAT_WHOLE_STEPS = 4
# planes of a slab launch: with its two halo planes, its input stays below
# 2^31 elements at the full-resolution concat's 192 channels
REMAT_SLAB = 40
# the whole-volume launches of the fixed UNet's step past 2^31 elements (or,
# B, near it), each held against its launches on depth slabs: (kernel,
# role, input channels, output channels); C reads the half resolution
REMAT_KERNEL_CASES = (
    ("conv3d_k3", "forward", 192, 64),      # the concat of 192 channels in
    ("conv3d_k3", "dx", 64, 192),           # ... and its gradient out
    ("conv3d_k3_wgrad", "wgrad", 192, 64),
    ("deconv2x", "forward", 128, 128),      # 128 channels out
    ("conv3d_point", "forward", 64, N_CLASSES),
    ("conv3d_point", "dx", N_CLASSES, 64))


def remat_extra(model):
    """What ``remat`` adds to a training step's launches: one forward of
    every ConvBlock and DeconvBlock that recomputes."""
    from deepatlas_torch.models import layers

    return {"conv3d_k3": sum(isinstance(m, layers.ConvBlock) and m.remat
                             for m in model.modules()),
            "deconv2x": sum(isinstance(m, layers.DeconvBlock) and m.remat
                            for m in model.modules())}


def differing(a, b):
    """Names whose tensors differ in a bit, a shape or the type."""
    import torch

    return sorted(k for k in a if a[k].shape != b[k].shape
                  or a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]))


def snapshot(model, metrics):
    """Copies of a step's metrics, the model's gradients and state."""
    return {"metrics": {k: v.detach().clone() for k, v in metrics.items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def differences(a, b):
    """``differing`` of two snapshots, part by part (empty: equal)."""
    out = {part: differing(a[part], b[part]) for part in a}
    return {part: names for part, names in out.items() if names}


def timed_steps(state, step, args, n, metrics_of):
    """``n`` steps ``step(state, *args)`` from the state as given: the
    seconds (synchronised) and launches of each, snapshots after the first
    and the last, the peak memory over them."""
    import torch

    from deepatlas_torch.kernels import launch_counts

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = {"seconds": [], "launches": []}
    for i in range(n):
        before = launch_counts()
        t0 = time.perf_counter()
        out = step(state, *args)
        torch.cuda.synchronize()
        run["seconds"].append(time.perf_counter() - t0)
        after = launch_counts()
        run["launches"].append({k: after[k] - before[k] for k in after})
        if i in (0, n - 1):
            run["last"] = snapshot(state.model, metrics_of(out))
            run.setdefault("first", run["last"])
    run["peak"] = torch.cuda.max_memory_allocated()
    return run


def remat_summary(name, runs, want):
    """The log entry of a remat-off / remat-on pair of ``timed_steps`` runs,
    and its faults: a bit that differs after the first or the last step, a
    step whose launches are not its table's, a remat peak not below the
    plain one."""
    entry, faults = {}, []
    for remat, run in runs.items():
        key = "remat" if remat else "plain"
        warm = sorted(run["seconds"][1:] or run["seconds"])
        entry[key] = {"step_s": run["seconds"],
                      "step_s_median": warm[len(warm) // 2],
                      "max_memory_allocated": run["peak"],
                      "launches_per_step": run["launches"][0],
                      "launches_expected": want[remat]}
        bad = [i for i, got in enumerate(run["launches"])
               if got != want[remat]]
        if bad:
            faults.append(f"{name} {key}: steps {bad} launched "
                          f"{run['launches'][bad[0]]}, expected "
                          f"{want[remat]}")
    for which in ("first", "last"):
        diff = differences(runs[False][which], runs[True][which])
        entry[f"differs_after_{which}_step"] = diff
        if diff:
            faults.append(f"{name}: remat differs after the {which} step in "
                          f"{diff}")
    entry["peak_ratio"] = runs[True]["peak"] / runs[False]["peak"]
    if not runs[True]["peak"] < runs[False]["peak"]:
        faults.append(f"{name}: remat peak {runs[True]['peak']} not below "
                      f"{runs[False]['peak']}")
    return entry, faults


def cropped(volume, crop=MB_CROP):
    """The recipe's crop of a MindBoggle-layout volume."""
    return volume[tuple(slice(c, n - e) for c, n, e in
                        zip(crop[:3], volume.shape, crop[3:]))]


def on_card(array, dtype=None):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(array)[None])
    return (t if dtype is None else t.to(dtype)).cuda()


def remat_seg_part(seed):
    """(a) UNet_light on train_seg.py's recipe: 8 steps with remat off and
    on from one seeded state on one 168x200x168 volume; then the remat
    net's serving forward of one tile batch."""
    import torch

    import train_seg_torch
    from deepatlas_torch.kernels import launch_counts
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network, resolve_model_settings
    from deepatlas_torch.train import (TrainState, make_optimizer,
                                       make_seg_train_step,
                                       make_tile_predictor)

    config = train_seg_torch.build_config(train_seg_torch.parse_args(
        ["--data-root", "unused", "--device", "cuda"]))
    img, seg = mindboggle_volume(np.random.RandomState(seed + 13))
    x = on_card(cropped(img)[..., None])
    y = on_card(cropped(seg), torch.int64)
    step = make_seg_train_step(get_loss_function(config["loss"])(
        **config["loss_settings"]))
    runs, models = {}, {}
    for remat in (False, True):
        model = get_network(config["model"])(**resolve_model_settings(
            config["model_settings"]), remat=remat)
        model.load_state_dict(seeded_state(model, seed + 13))
        model.cuda()
        state = TrainState(model, make_optimizer(model,
                                                 config["learning_rate"]))
        runs[remat] = timed_steps(state, step, (x, y), REMAT_STEPS,
                                  lambda out: {"loss": out[1]})
        models[remat] = model
    want = {False: STEP_LAUNCHES,
            True: add_launches(STEP_LAUNCHES, remat_extra(models[True]))}
    entry, faults = remat_summary("UNet_light", runs, want)
    tiles = np.random.RandomState(seed).rand(
        TILE_BATCH, TILE, TILE, TILE, 1).astype(np.float32)
    before = launch_counts()
    make_tile_predictor(models[True], TILE_BATCH)(tiles)
    after = launch_counts()
    entry["serving_launches"] = {k: after[k] - before[k] for k in after}
    if entry["serving_launches"] != EVAL_LAUNCHES:
        faults.append(f"UNet_light with remat serves one tile batch with "
                      f"{entry['serving_launches']}, expected "
                      f"{EVAL_LAUNCHES}")
    entry.update(shape=TRAIN_SHAPE, n_classes=TRAIN_CLASSES,
                 blocks_recomputed=remat_extra(models[True]))
    return entry, faults


def remat_reg_part(seed):
    """(b) VoxelMorph on train_reg.py's recipe: 8 steps with remat off and
    on from one seeded state on the first pair of the reg phase's
    corpus."""
    import train_reg_torch
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network, resolve_model_settings
    from deepatlas_torch.train import (TrainState, make_optimizer,
                                       make_reg_train_step)

    config = train_reg_torch.build_config(train_reg_torch.parse_args(
        ["--data-root", "unused", "--device", "cuda"]))
    volumes = reg_volumes(seed)
    moving, fixed = (on_card(cropped(next(volumes)[0])[..., None])
                     for _ in range(2))
    runs, models = {}, {}
    for remat in (False, True):
        model = get_network(config["model"])(**resolve_model_settings(
            config["model_settings"]), remat=remat)
        model.load_state_dict(seeded_state(model, seed + 14))
        model.cuda()
        step = make_reg_train_step(
            get_loss_function(config["loss"])(**config["loss_settings"]),
            get_loss_function(config["reg_loss"])(
                **config["reg_loss_settings"]),
            config["reg_weight"], max_disp=model.max_disp)
        state = TrainState(model, make_optimizer(model,
                                                 config["learning_rate"]))
        runs[remat] = timed_steps(state, step, (moving, fixed), REMAT_STEPS,
                                  lambda out: out[1])
        models[remat] = model
    want = {False: REG_STEP_LAUNCHES,
            True: add_launches(REG_STEP_LAUNCHES, remat_extra(models[True]))}
    entry, faults = remat_summary("VoxelMorph", runs, want)
    entry.update(shape=TRAIN_SHAPE,
                 blocks_recomputed=remat_extra(models[True]))
    return entry, faults


def remat_joint_part(seed):
    """(c) The joint experiment's seg step (train_deepatlas.py's recipe,
    its steps built by the experiment) on one pair of the joint phase's
    corpus, ``REMAT_SHORT_STEPS`` steps per label regime with
    ``checkpoint_seg_apply`` off and on, each from the same seeded
    state."""
    import torch

    import train_deepatlas_torch
    from deepatlas_torch.train import DeepAtlasExperiment, TrainState
    from deepatlas_torch.train.steps import make_optimizer

    config = train_deepatlas_torch.build_config(
        train_deepatlas_torch.parse_args(
            ["--data-root", "unused", "--device", "cuda"]))
    exp = DeepAtlasExperiment(config)
    exp.setup_model()
    exp.setup_loss()
    exp._init_state()
    start = {"seg": seeded_state(exp.seg_model, seed + 15),
             "reg": seeded_state(exp.reg_model, seed + 16)}
    volumes = reg_volumes(seed, intensity=JOINT_INTENSITY)
    (m_img, m_seg), (f_img, f_seg) = next(volumes), next(volumes)
    images = [on_card(cropped(v)[..., None]) for v in (m_img, f_img)]
    labels = [on_card(cropped(v), torch.int64) for v in (m_seg, f_seg)]
    # each of the step's two differentiated applies recomputes one forward
    # of the whole net
    extra = add_launches(EVAL_LAUNCHES, EVAL_LAUNCHES)
    entry, faults = {}, []
    for index, regime in enumerate(REGIMES):
        flags = [torch.tensor([bool(index & 2)]),
                 torch.tensor([bool(index & 1)])]
        runs = {}
        for on in (False, True):
            exp.seg_model.load_state_dict(start["seg"])
            exp.reg_model.load_state_dict(start["reg"])
            exp.seg_state = TrainState(exp.seg_model, make_optimizer(
                exp.seg_model, config["learning_rate"]))
            exp.config["checkpoint_seg_apply"] = on
            exp._build_steps()
            runs[on] = timed_steps(
                exp.seg_state,
                lambda state, *t: exp.seg_step(state, exp.reg_state, *t),
                (*images, *labels, *flags), REMAT_SHORT_STEPS,
                lambda out: out[1])
        plain = joint_seg_launches(regime)
        part, bad = remat_summary(f"joint seg {regime}", runs,
                                  {False: plain,
                                   True: add_launches(plain, extra)})
        entry[regime] = part
        faults += bad
    return entry, faults


def remat_oai_config(workdir, depth, steps, remat):
    """The seg CLI's config on the OAI corpus in ``workdir`` for the fixed
    UNet (bias, BatchNorm, bf16) with 5 classes and ``remat``, whole
    volumes cut to their middle ``depth`` planes, batch 1, ``steps``
    steps and one validation."""
    import train_seg_torch

    config = train_seg_torch.build_config(train_seg_torch.parse_args(
        ["--data-root", workdir, "--log-root", f"logs_{depth}_{remat}",
         "--num-samples", "21", "--num-epochs", "1", "--preload",
         "--device", "cuda"]))
    cut = (OAI_SHAPE[0] - depth) // 2
    config.update(
        data="OAI", model="UNet", n_classes=N_CLASSES,
        class_name={k: str(k) for k in range(1, N_CLASSES)},
        model_settings=dict(config["model_settings"], n_classes=N_CLASSES,
                            remat=remat),
        loss_settings=dict(config["loss_settings"], n_class=N_CLASSES),
        crop_size=[cut, 0, 0, cut, 0, 0] if cut else None, batch_size=1,
        samples_per_epoch=steps, data_dir=workdir, valid_data_dir=workdir,
        training_list_file=os.path.join(workdir, "train.txt"),
        validation_list_file=os.path.join(workdir, "valid.txt"),
        testing_list_file=os.path.join(workdir, "valid.txt"))
    return config


def remat_oai_run(workdir, depth, steps, remat):
    """One seg experiment of ``remat_oai_config``: its recorder, the
    model's snapshot after training and the experiment's seconds."""
    import torch

    from deepatlas_torch.train import SegmentationExperiment, segmentation

    rec = StepRecorder(track_peak=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.chdir(workdir), \
            contextlib.redirect_stdout(io.StringIO()), \
            mock.patch.object(segmentation, "make_seg_train_step",
                              rec.train_factory(
                                  segmentation.make_seg_train_step)):
        exp = SegmentationExperiment(
            remat_oai_config(workdir, depth, steps, remat))
        exp.train()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    shot = snapshot(exp.model, {"loss": torch.tensor(rec.losses)})
    extra = remat_extra(exp.model)
    del exp
    return rec, shot, extra, seconds


def write_remat_corpus(workdir, seed):
    """Two synthetic OAI volumes: one trains, one validates."""
    names = write_corpus(workdir, seed + 17, n_volumes=2)
    for list_name, part in (("train.txt", names[:1]),
                            ("valid.txt", names[1:])):
        with open(os.path.join(workdir, list_name), "w") as f:
            f.write("\n".join(part) + "\n")


def remat_half_part(workdir):
    """(d) The fixed UNet through the seg experiment on a synthetic OAI
    volume's middle ``REMAT_HALF_DEPTH`` planes: ``REMAT_SHORT_STEPS``
    steps with remat off and as many with it on, bit for bit after the
    last, the warm steps' median seconds, both peaks."""
    entry, faults, shots = {}, [], {}
    for remat in (False, True):
        rec, shots[remat], extra, seconds = remat_oai_run(
            workdir, REMAT_HALF_DEPTH, REMAT_SHORT_STEPS, remat)
        want = add_launches(STEP_LAUNCHES, extra) if remat else STEP_LAUNCHES
        key = "remat" if remat else "plain"
        warm = sorted(rec.seconds[1:])
        entry[f"half_{key}"] = {"losses": rec.losses,
                                "step_s": rec.seconds,
                                "step_s_median": warm[len(warm) // 2],
                                "max_memory_allocated": max(rec.peaks),
                                "launches_per_step": rec.step_launches[0],
                                "launches_expected": want,
                                "experiment_s": seconds}
        if rec.step_launches != [want] * REMAT_SHORT_STEPS:
            faults.append(f"UNet at {REMAT_HALF_DEPTH} planes {key}: "
                          f"launched {rec.step_launches}, expected {want}")
    diff = differences(shots[False], shots[True])
    half = entry["half_plain"], entry["half_remat"]
    entry["half_differs"] = diff
    entry["half_peak_ratio"] = half[1]["max_memory_allocated"] / \
        half[0]["max_memory_allocated"]
    if diff:
        faults.append(f"UNet at {REMAT_HALF_DEPTH} planes: remat differs in "
                      f"{diff}")
    if not half[1]["max_memory_allocated"] < half[0]["max_memory_allocated"]:
        faults.append("UNet: the remat peak is not below the plain one")
    entry.update(depth=REMAT_HALF_DEPTH, blocks_recomputed=extra)
    return entry, faults


# the whole volume fits one card with remat only under PyTorch's
# expandable-segments allocator, whose segments grow in place: with the
# default one, blocks reserved but unallocated between the step's tensors
# run the step out of memory from 144 planes on, on "NVIDIA H100 80GB
# HBM3, 700.00 W" (``python3 chip_smoke.py --remat-depths``).  A user sets
# it in the environment, so the part runs in a process of its own with it
# set.
REMAT_WHOLE_ALLOC_CONF = "expandable_segments:True"


def remat_child(workdir, depth, alloc_conf):
    """``_remat_whole_child`` on ``depth`` planes in a process of its own,
    with ``PYTORCH_CUDA_ALLOC_CONF`` set to ``alloc_conf`` (None: PyTorch's
    default allocator): the finished process."""
    env = dict(os.environ)
    env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    if alloc_conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    return subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--remat-whole", workdir, "--remat-depth",
                           str(depth)], env=env, capture_output=True,
                          text=True, timeout=600)


def remat_whole_part(workdir, plain_half_peak):
    """(d) ``REMAT_WHOLE_STEPS`` steps of the fixed UNet with remat through
    the seg experiment on ``REMAT_WHOLE_DEPTH`` planes of an OAI volume
    (all of them), in a child process (``remat_child``) under
    ``REMAT_WHOLE_ALLOC_CONF``: finite losses, the step's median seconds
    and peak.  The peak without remat is ``plain_half_peak`` scaled by
    depth, and is marked so.  Returns the entry, the faults and the child's
    launches."""
    t0 = time.perf_counter()
    out = remat_child(workdir, REMAT_WHOLE_DEPTH, REMAT_WHOLE_ALLOC_CONF)
    if out.returncode:
        raise AssertionError(f"the whole-volume remat child failed:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    entry = dict(child["entry"], process_s=time.perf_counter() - t0,
                 alloc_conf=REMAT_WHOLE_ALLOC_CONF,
                 plain_peak_scaled_from_half=plain_half_peak
                 * REMAT_WHOLE_DEPTH / REMAT_HALF_DEPTH,
                 plain_peak_is_scaled=True)
    return entry, child["faults"], child["launches"]


def _remat_whole_child(workdir, depth):
    """The whole-volume part's process: the kernels as built, the seg
    experiment's ``REMAT_WHOLE_STEPS`` remat steps on ``depth`` planes, one
    JSON line with the entry, the faults and the launches."""
    import torch

    sys.path.insert(0, REPO)
    from deepatlas_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    faults = []
    rec, _, extra, seconds = remat_oai_run(workdir, depth,
                                           REMAT_WHOLE_STEPS, True)
    want = add_launches(STEP_LAUNCHES, extra)
    warm = sorted(rec.seconds[1:])
    entry = {
        "depth": depth, "losses": rec.losses,
        "step_s": rec.seconds, "step_s_median": warm[len(warm) // 2],
        "max_memory_allocated": max(rec.peaks), "peaks": rec.peaks,
        "max_memory_reserved": torch.cuda.max_memory_reserved(),
        "card_bytes": torch.cuda.get_device_properties(0).total_memory,
        "launches_per_step": rec.step_launches[0],
        "launches_expected": want, "experiment_s": seconds}
    if len(rec.losses) != REMAT_WHOLE_STEPS \
            or not np.all(np.isfinite(rec.losses)):
        faults.append(f"UNet whole volume: losses {rec.losses}")
    if any(got != want for got in rec.step_launches):
        faults.append(f"UNet whole volume: launched {rec.step_launches}, "
                      f"expected {want}")
    print(json.dumps({"entry": entry, "faults": faults,
                      "launches": launch_counts()}), flush=True)
    return 0


def remat_depth_scan(seed, depths):
    """How deep an OAI volume the fixed UNet trains on with remat on one
    card: ``_remat_whole_child`` at each of ``depths`` under PyTorch's
    default allocator and under ``REMAT_WHOLE_ALLOC_CONF``, one JSON line
    each (a child that ran out of memory: its last error line)."""
    print(nvidia_smi(), flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        write_remat_corpus(workdir, seed)
        for alloc_conf in (None, REMAT_WHOLE_ALLOC_CONF):
            for depth in depths:
                out = remat_child(workdir, depth, alloc_conf)
                row = {"depth": depth, "alloc_conf": alloc_conf,
                       "rc": out.returncode}
                if out.returncode == 0:
                    row.update(json.loads(
                        out.stdout.strip().splitlines()[-1])["entry"])
                else:
                    row["error"] = ([ln for ln in out.stderr.splitlines()
                                     if "Error" in ln] or [""])[-1][:1000]
                log(row)
    return 0


def run_remat_path(seed, workdir):
    """Phase remat: per-block remat and the joint step's
    ``checkpoint_seg_apply`` against the same steps without them, bit for
    bit (loss, gradients, BatchNorm statistics, parameters), with launches
    per step against the tables (remat adds one forward of every conv and
    deconv block; ``checkpoint_seg_apply`` one forward of the seg net per
    differentiated apply), times and peaks: (a) UNet_light and (b)
    VoxelMorph on their recipes, (c) the joint seg step in each label
    regime, (d) the fixed UNet through the seg experiment on OAI volumes,
    at half the depth both ways and on the whole volume with remat."""
    import torch

    from deepatlas_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    write_remat_corpus(workdir, seed)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    faults = []
    for name, part in (("unet_light", lambda: remat_seg_part(seed)),
                       ("voxelmorph", lambda: remat_reg_part(seed)),
                       ("joint_seg", lambda: remat_joint_part(seed)),
                       ("unet_oai_half", lambda: remat_half_part(workdir))):
        t1 = time.perf_counter()
        entry, bad = part()
        # each part's line as it ends: a later part may not
        log({"phase": "remat", "part": name, **entry, "faults": bad,
             "seconds": time.perf_counter() - t1})
        faults += bad
        # the experiments sit in reference cycles: collect them before
        # their blocks can go back to the card
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = launch_counts()
    half_plain_peak = entry["half_plain"]["max_memory_allocated"]
    # the whole volume needs all but about 1 GB of the card: this process
    # holds only its context meanwhile
    parent = {"parent_memory_reserved": torch.cuda.memory_reserved(),
              "card_free_bytes_at_start": torch.cuda.mem_get_info()[0]}
    entry, bad, child = remat_whole_part(workdir, half_plain_peak)
    log({"phase": "remat", "part": "unet_oai_whole", **entry, **parent,
         "faults": bad})
    faults += bad
    counts = add_launches(counts, child)
    log({"phase": "remat", "launches": counts, "corpus_s": setup_s,
         "seconds": time.perf_counter() - t0, "oai_shape": OAI_SHAPE,
         "n_classes": N_CLASSES, "faults": faults})
    if faults:
        raise AssertionError("remat: " + "; ".join(faults))
    return counts


def halo_slab(t, start, n):
    """Planes ``start - 1 .. start + n`` of ``t`` (batch 1), zero planes
    past the volume's ends: a depth shard with one halo plane each side,
    as a contiguous copy."""
    import torch

    zero = torch.zeros_like(t[:, :1])
    lo = t[:, start - 1:start] if start > 0 else zero
    hi = t[:, start + n:start + n + 1] if start + n < t.shape[1] else zero
    return torch.cat([lo, t[:, start:start + n], hi], dim=1)


def remat_kernel_case(kernel, role, cin, cout, dhw, gen, slab,
                      device="cuda"):
    """One whole-volume launch of ``REMAT_KERNEL_CASES`` on random inputs
    and the same kernel on depth slabs of ``slab`` planes (C: of the half
    resolution's ``slab // 2``).  Returns the full call, the plain one and
    the library one on each slab, and ``compare()``: the full output
    against the slabs' (A, B, C bit for bit; D: the full weight gradient
    against the sum of the slabs', within ``TOL["float32"]``), and the
    first slab's kernel output against its plain version."""
    import torch

    from deepatlas_torch.kernels import (KERNELS, conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain)

    def rand(shape):
        return (torch.rand(shape, generator=gen, device=device) * 2
                - 1).to(torch.bfloat16)

    def weights(shape, fan):
        return torch.randn(shape, generator=gen, device=device) / np.sqrt(fan)

    d, h, w = dhw
    fn, plain = KERNELS[kernel]
    starts = range(0, d, slab)
    if kernel == "deconv2x":
        x = rand((1, d // 2, h // 2, w // 2, cin))
        wk = weights((2, 2, 2, cin, cout), cin)
        full = lambda: fn(x, wk)
        pieces = [((x[:, s // 2:(s + slab) // 2],), {}, slice(s, s + slab),
                   slice(None)) for s in starts]
    elif kernel == "conv3d_point":
        x = rand((1, d, h, w, cin))
        wk = weights((cin, cout), cin)
        full = lambda: fn(x, wk)
        pieces = [((x[:, s:s + slab],), {}, slice(s, s + slab), slice(None))
                  for s in starts]
    elif role == "dx":
        # the stride-1 input gradient at depth padding 0 of a slab of the
        # upstream gradient with its halo: its planes 2 .. slab + 1 are the
        # full gradient's
        x = rand((1, d, h, w, cin))
        wk = weights((3, 3, 3, cout, cin), 27 * cin)
        fn, plain = conv3d_k3_input_grad, conv3d_k3_input_grad_plain
        full = lambda: fn(x, wk, dhw, 1)
        pieces = [((halo_slab(x, s, slab),),
                   {"dhw": (slab + 4, h, w), "stride": 1, "pad_d": 0},
                   slice(s, s + slab), slice(2, slab + 2)) for s in starts]
    else:
        x = rand((1, d, h, w, cin))
        if kernel == "conv3d_k3":
            wk = weights((3, 3, 3, cin, cout), 27 * cin)
            full = lambda: fn(x, wk)
        else:
            wk = rand((1, d, h, w, cout))     # the upstream gradient
            full = lambda: fn(x, wk)
        pieces = [((halo_slab(x, s, slab),), {"pad_d": 0},
                   slice(s, s + slab), slice(None)) for s in starts]
    if kernel == "conv3d_k3_wgrad":
        calls = [((a[0], wk[:, s:s + slab]), kw, full_sl, own)
                 for (a, kw, full_sl, own), s in zip(pieces, starts)]
    else:
        calls = [((a[0], wk), kw, full_sl, own)
                 for a, kw, full_sl, own in pieces]

    def compare():
        out = full()
        first = None
        if kernel == "conv3d_k3_wgrad":
            total = torch.zeros_like(out)
            for i, (args, kw, _, _) in enumerate(calls):
                got = fn(*args, **kw)
                first = got if i == 0 else first
                total += got
            err = (total - out).abs().max().item()
            equal = err <= TOL["float32"] * out.abs().max().item()
        else:
            equal, err = True, 0.0
            for i, (args, kw, full_sl, own) in enumerate(calls):
                got = fn(*args, **kw)[:, own]
                first = got if i == 0 else first
                ref = out[:, full_sl]
                equal = equal and bool(torch.equal(got, ref))
                err = max(err, (got.float() - ref.float()).abs().max().item())
                del got, ref
        args, kw, _, own = calls[0]
        ref = plain(*args, **kw)[:, own] if kernel != "conv3d_k3_wgrad" \
            else plain(*args, **kw)
        plain_err = (first.float() - ref.float()).abs().max().item()
        plain_scale = ref.float().abs().max().item()
        return {"full_elements_in": x.numel(), "full_elements_out":
                out.numel(), "equal_to_slabs": equal,
                "max_abs_err_vs_slabs": err, "slabs": len(calls),
                "max_abs_err_vs_plain": plain_err,
                "max_abs_plain": plain_scale}

    return x, wk, full, calls, compare


def check_remat_kernels(summary, seed, dhw=OAI_SHAPE, slab=REMAT_SLAB,
                        device="cuda"):
    """Phase 3, the fixed UNet's training step on a whole OAI volume: A, B,
    C and D at ``REMAT_KERNEL_CASES``, where A's input and output gradient
    hold 4.53e9 elements and C's output 3.02e9 (past 2^31, where the plain
    versions and cuDNN cannot run whole), each launch held against the
    same kernel on depth slabs (``remat_kernel_case``) and its first slab
    against the plain version; timed whole (``ms``, ``device_ms``), the
    plain versions, cuDNN and B's and C's CUDA-core kernels summed over the
    slabs.  Fills the path ``remat`` of ``summary``: one call of each
    case."""
    import torch

    from deepatlas_torch.kernels import KERNELS

    gen = torch.Generator(device=device).manual_seed(seed + 18)
    for kernel, role, cin, cout in REMAT_KERNEL_CASES:
        x, wk, full, calls, compare = remat_kernel_case(
            kernel, role, cin, cout, dhw, gen, slab, device)
        res = compare()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ms = cuda_ms(full, reps=2)
        dev_ms = cuda_ms(full, reps=2, queued=True)
        fn, plain = KERNELS[kernel]
        if role == "dx" and kernel == "conv3d_k3":
            from deepatlas_torch.kernels import conv3d_k3_input_grad_plain
            plain = conv3d_k3_input_grad_plain
        plain_ms = sum(cuda_ms(lambda: plain(*a, **kw), reps=1, warmup=0)
                       for a, kw, _, _ in calls)
        libs = [library_call(kernel, a[0], a[1], 1, kw.get("dhw"),
                             kw.get("pad_d", 1)) for a, kw, _, _ in calls]
        lib_ms = sum(cuda_ms(lib, reps=2) for lib in libs)
        lib_dev_ms = sum(cuda_ms(lib, reps=2, queued=True) for lib in libs)
        # the CUDA-core twin of B and C over the same slabs
        simt_ms = simt_dev_ms = None
        if kernel in CUDA_CORE_TWINS:
            simts = [cuda_core_call(kernel, a[0], a[1])
                     for a, _, _, _ in calls]
            simt_ms = sum(cuda_ms(simt, reps=2) for simt in simts)
            simt_dev_ms = sum(cuda_ms(simt, reps=2, queued=True)
                              for simt in simts)
            del simts
        n = int(np.prod(dhw)) // (8 if kernel == "deconv2x" else 1)
        bms, bound_by = bound_ms(kernel, n, cin, cout, "bfloat16")
        flops, nbytes = work(kernel, n, cin, cout, "bfloat16")
        tol = TOL["float32"] if kernel == "conv3d_k3_wgrad" \
            else TOL["bfloat16"]
        ok = res["equal_to_slabs"] and \
            res["max_abs_err_vs_plain"] <= tol * res["max_abs_plain"]
        partial = wgrad_partial_bytes("bfloat16", 1, dhw, cin, cout) \
            if kernel == "conv3d_k3_wgrad" else None
        log({"phase": "remat_kernels", "kernel": kernel, "role": role,
             "x": list(x.shape), "cin": cin, "cout": cout, **res,
             "wgrad_partial_bytes": partial,
             "slab_planes": slab, "rel_tol_plain": tol, "ok": ok,
             "kernel_ms": ms, "kernel_device_ms": dev_ms,
             "plain_ms_over_slabs": plain_ms,
             "library_ms_over_slabs": lib_ms,
             "library_device_ms_over_slabs": lib_dev_ms,
             "cuda_core_ms_over_slabs": simt_ms,
             "cuda_core_device_ms_over_slabs": simt_dev_ms,
             "bound_ms": bms, "bound_by": bound_by})
        if not ok:
            raise AssertionError(f"{kernel} {role} at {tuple(x.shape)}: "
                                 f"{res}")
        tot = summary[kernel]["remat"]
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bms),
                         ("flops", flops), ("bytes", nbytes),
                         ("device_ms", dev_ms),
                         ("library_device_ms", lib_dev_ms),
                         ("cuda_core_ms", simt_ms or 0.0),
                         ("cuda_core_device_ms", simt_dev_ms or 0.0)):
            tot[key] += val
        summary[kernel]["max_abs_err"] = max(summary[kernel]["max_abs_err"],
                                             res["max_abs_err_vs_plain"])
        del x, wk, full, calls, compare, libs
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nccl-cli", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--remat-whole", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--remat-depth", type=int, default=REMAT_WHOLE_DEPTH,
                    help=argparse.SUPPRESS)
    ap.add_argument("--remat-depths", type=int, nargs="+", default=None,
                    help="only scan these OAI depths (even, at most 160) for "
                         "the fixed UNet's remat step under both allocators")
    args = ap.parse_args(argv)
    if args.nccl_cli:
        # the parallel phase's NCCL child, started by torchrun
        return _nccl_cli(args.nccl_cli)
    if args.remat_whole:
        # the remat phase's whole-volume child
        return _remat_whole_child(args.remat_whole, args.remat_depth)

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
    if args.remat_depths:
        return remat_depth_scan(args.seed, args.remat_depths)
    smi = nvidia_smi()
    print(smi, flush=True)
    log({"phase": "device", "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
         "imports": optional_imports()})

    t0 = time.perf_counter()
    seconds = build.build()
    ptxas = [ln.strip() for log_text in build.build_logs.values()
             for ln in log_text.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "per_source_s": seconds, "ptxas": ptxas,
         "per_source": {name: ptxas_summary(text)
                        for name, text in build.build_logs.items()}})
    check_native()

    with torch.no_grad():
        summary = check_kernels(args.seed)
        check_upsample(args.seed)
        block = check_block_kernel(args.seed)
    check_warp_kernels(summary, args.seed)
    check_augment_field(summary, args.seed)
    apart = check_anatomy_kernels(summary, args.seed)
    check_remat_kernels(summary, args.seed)
    convs = run_conv_tools()

    launches = {}
    for path, run in (("serving", run_main_path), ("training", run_train_path),
                      ("registration", run_reg_path),
                      ("joint", run_joint_path),
                      ("unet_serving", run_unet_serving_path),
                      ("unet_training", run_unet_train_path),
                      ("oai_patch_training", run_oai_patch_path),
                      ("parallel", run_parallel_path),
                      ("remat", run_remat_path)):
        with tempfile.TemporaryDirectory() as workdir:
            launches[path] = run(args.seed, workdir)

    step_tables = (STEP_LAUNCHES, EVAL_LAUNCHES, REG_STEP_LAUNCHES,
                   REG_EVAL_LAUNCHES, PATCH_STEP_LAUNCHES,
                   joint_reg_launches(0),
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
                 "step of VoxelMorph (168x200x168), for 'joint', one "
                 "reg step without label substitution plus four seg steps, "
                 "one in each label regime (soft, f_hard, m_hard, hard), "
                 "and, for 'unet_serving' and 'unet_training', a tile "
                 "batch and a training step of the fixed UNet, and, for "
                 "'oai_patch_training', one OAI patch step (UNet_light, 5 "
                 "classes, 2 x 128^3, bfloat16; E: the augmenter's two "
                 "warps on the kernels phase's field 'augment'): "
                 "bfloat16 for the convolutions, the smooth field for the "
                 "warp and anatomy kernels (float32 with one channel for "
                 "the image warps and the splat of ones, 32 channels for "
                 "the anatomy warps and splats, random values: the f-hard "
                 "splat's one-hot stands in the kernels phase's line "
                 "joint_unit_with_f_hard_one_hot); matched_grid_grad, which "
                 "no main path launches, gives its time per call. launches "
                 "are the main paths' runs, read when each returns; "
                 "max_abs_err is the largest over every shape "
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
                 "before the tensor-core kernel. 'parallel' holds kernels A "
                 "and D at depth padding 0 (the spatial tier's shards, "
                 "one halo plane on each side) over one unit: a spatial "
                 "UNet_light training step and a spatial VoxelMorph step on "
                 "rank 0's 80x200x168 shard and the spatial serving forward "
                 "of an 80x384x384 OAI shard (bfloat16), library_ms cuDNN "
                 "with depth padding 0; its launches are both ranks' of the "
                 "parallel phase's gloo runs and the NCCL CLI's. "
                 "'remat' holds A, B, C and D of the fixed UNet's step on "
                 "a whole 160x384x384 OAI volume (bfloat16, 5 classes) "
                 "over one call of each case of REMAT_KERNEL_CASES (A: "
                 "the 192 -> 64 forward and its input gradient, D: that "
                 "weight gradient, C: 128 -> 128 to full resolution, B: "
                 "the head 64 -> 5 and its input gradient): ms and "
                 "device_ms of the whole-volume launch, plain_ms, "
                 "library_ms and library_device_ms summed over its "
                 "40-plane depth slabs (no plain version or cuDNN call "
                 "runs at the whole volume's 2^31-element tensors), "
                 "cuda_core_ms and cuda_core_device_ms of B and C summed "
                 "over the same slabs; its launches are the remat phase's "
                 "runs"})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
