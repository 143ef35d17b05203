#!/usr/bin/env python3
"""Smoke run of deepatlas_torch on one CUDA card: the quickest proof that
the PyTorch port builds, is right and runs its main path on the GPU.

Phases (one JSON line each, any failure exits nonzero before the last line):

  1. device  -- card name, ``nvidia-smi`` name and power limit; TF32 off for
     every float32 reference.
  2. build   -- compile the CUDA sources of deepatlas_torch/kernels/csrc.
  3. kernels -- each kernel against its plain PyTorch version at every
     shape the two main paths launch it at, in float32 and bfloat16, with
     kernel / plain / library (cuDNN) times from CUDA events and the least
     time the card could take (``bound_ms``).  Serving: the UNet_light tile
     forward (batch 4 of 128^3 tiles).  Training: one step on a 168x200x168
     volume with 32 classes -- the forward convs, kernel A again at its 13
     input-gradient shapes (Cin and Cout swapped), the head's kernel at its
     input-gradient shape, and the k3 weight-gradient kernel at its 14
     shapes.
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
}

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
                 "conv3d_k3_wgrad": 14}
EVAL_LAUNCHES = {"conv3d_k3": 14, "deconv2x": 3, "conv3d_point": 1,
                 "conv3d_k3_wgrad": 0}


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


def all_cases():
    cases = unet_cases("serving", TILE_BATCH, (TILE,) * 3, N_CLASSES, False)
    cases.update(unet_cases("training", 1, TRAIN_SHAPE, TRAIN_CLASSES, True))
    return cases


def work(kernel, n, cin, cout, dtype_name):
    """(flops, bytes) the function needs on ``n`` voxels: each input read
    once, each output written once (weights as the float32 the kernels
    read; the weight gradient is written in float32)."""
    s = 2 if dtype_name == "bfloat16" else 4
    if kernel in ("conv3d_k3", "conv3d_k3_wgrad"):
        return 2 * 27 * cin * cout * n, n * cin * s + 27 * cin * cout * 4 \
            + n * cout * s
    if kernel == "conv3d_point":
        return 2 * cin * cout * n, n * cin * s + cin * cout * 4 + n * cout * s
    return 2 * 8 * cin * cout * n, n * cin * s + 8 * cin * cout * 4 \
        + 8 * n * cout * s


def bound_ms(kernel, n, cin, cout, dtype_name):
    flops, nbytes = work(kernel, n, cin, cout, dtype_name)
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


def library_call(kernel, x, w):
    """One PyTorch (cuDNN) call computing the same function: the yardstick
    for ``library_ms`` only; the port never calls it.  For the weight
    gradient ``w`` is the upstream gradient."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)           # NDHWC storage, NCDHW view
    if kernel == "conv3d_k3_wgrad":
        gc = w.permute(0, 4, 1, 2, 3)
        size = (w.shape[-1], x.shape[-1], 3, 3, 3)
        return lambda: torch.nn.grad.conv3d_weight(xc, size, gc, padding=1)
    wk = w.to(x.dtype)
    if kernel == "conv3d_k3":
        return lambda: F.conv3d(xc, wk.permute(4, 3, 0, 1, 2), padding=1)
    if kernel == "conv3d_point":
        return lambda: F.conv3d(xc, wk.permute(1, 0)[:, :, None, None, None])
    return lambda: F.conv_transpose3d(xc, wk.permute(3, 4, 0, 1, 2), stride=2)


def check_kernels(seed):
    """Phase 3: every kernel against its plain version at every shape of
    both paths in both types.  Returns ``{kernel: {"max_abs_err", path:
    {ms, plain_ms, library_ms, bound_ms, flops, bytes}}}`` with the bfloat16
    totals of one unit of each path (a tile batch; a training step)."""
    import torch

    from deepatlas_torch.kernels import KERNELS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "flops", "bytes")
    summary = {name: {"max_abs_err": 0.0,
                      "serving": dict.fromkeys(keys, 0.0),
                      "training": dict.fromkeys(keys, 0.0)}
               for name in KERNELS}
    for (path, name, role, batch, size, cin, cout), per_unit in \
            all_cases().items():
        fn, plain = KERNELS[name]
        n = batch * int(np.prod(size))
        big = n * max(cin, cout) > 2e8      # fewer repeats on the largest
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = (torch.rand((batch,) + size + (cin,), generator=gen,
                            device="cuda") * 2 - 1).to(dtype)
            if name == "conv3d_k3_wgrad":
                second = (torch.rand((batch,) + size + (cout,), generator=gen,
                                     device="cuda") * 2 - 1).to(dtype)
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
            got = fn(*args)
            ref = plain(*args)
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
            ms = cuda_ms(lambda: fn(*timed_args), reps=3 if big else 5)
            plain_ms = cuda_ms(lambda: plain(*timed_args),
                               reps=1 if big else 2, warmup=0 if big else 1)
            lib_ms = cuda_ms(library_call(name, x, second),
                             reps=3 if big else 5)
            bms, bound_by = bound_ms(name, n, cin, cout, dname)
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
                flops, nbytes = work(name, n, cin, cout, dname)
                tot = summary[name][path]
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms), ("bound_ms", bms),
                                 ("flops", flops), ("bytes", nbytes)):
                    tot[key] += per_unit * val
            del x, second, args, timed_args
    torch.cuda.empty_cache()
    return summary


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
    from deepatlas_torch.kernels import conv3d, deconv3d

    with mock.patch.object(conv3d, "_k3_cuda", conv3d._k3_math), \
            mock.patch.object(conv3d, "_wgrad_cuda", conv3d._wgrad_math), \
            mock.patch.object(conv3d, "_point_cuda", conv3d._point_math), \
            mock.patch.object(deconv3d, "_deconv_cuda",
                              deconv3d._deconv_math):
        yield


class StepRecorder:
    """Wraps the experiment's step factories to record, per training step,
    its loss, its seconds (synchronised) and the kernels it launched, and
    per evaluated volume its launches."""

    def __init__(self):
        self.losses, self.seconds, self.step_launches = [], [], []
        self.eval_launches = []
        self.first_start = self.last_end = None

    def _delta(self, before):
        from deepatlas_torch.kernels import launch_counts

        return {k: v - before[k] for k, v in launch_counts().items()}

    def train_factory(self, make):
        import torch

        from deepatlas_torch.kernels import launch_counts

        def factory(criterion):
            step = make(criterion)

            def recorded(state, images, labels):
                before = launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if self.first_start is None:
                    self.first_start = t0
                out = step(state, images, labels)
                torch.cuda.synchronize()
                self.last_end = time.perf_counter()
                self.seconds.append(self.last_end - t0)
                self.losses.append(float(out[1]))
                self.step_launches.append(self._delta(before))
                return out

            return recorded

        return factory

    def eval_factory(self, make):
        from deepatlas_torch.kernels import launch_counts

        def factory(n_class):
            step = make(n_class)

            def recorded(state, images, labels):
                before = launch_counts()
                out = step(state, images, labels)
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

    with tempfile.TemporaryDirectory() as workdir:
        serving = run_main_path(args.seed, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        training = run_train_path(args.seed, workdir)

    kernels = []
    for name, s in summary.items():
        src, replaces = KERNEL_INFO[name]
        paths = {path: s[path] for path in ("serving", "training")}
        flops = sum(p["flops"] for p in paths.values())
        nbytes = sum(p["bytes"] for p in paths.values())
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces,
                 "launches": serving[name] + training[name],
                 "max_abs_err": s["max_abs_err"]}
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            entry[key] = sum(p[key] for p in paths.values())
        entry["bound_by"] = "operations" \
            if flops / PEAK_FLOPS["bfloat16"] >= nbytes / HBM_BYTES_PER_S \
            else "bytes"
        entry["serving"] = dict(
            {k: paths["serving"][k]
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            launches=serving[name])
        entry["training"] = dict(
            {k: paths["training"][k]
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            launches=training[name])
        kernels.append(entry)
    print(nvidia_smi(), flush=True)
    log({"kernels": kernels,
         "note": "ms, plain_ms, library_ms and bound_ms are bfloat16 totals "
                 "over one tile batch (4 x 128^3) of the serving path plus "
                 "one training step (168x200x168, 32 classes) of "
                 "UNet_light, split under 'serving' and 'training'; "
                 "launches are the two main paths' runs; max_abs_err is "
                 "the largest over every shape and type"})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
