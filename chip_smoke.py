#!/usr/bin/env python3
"""Smoke run of deepatlas_torch on one CUDA card: the quickest proof that
the PyTorch port builds, is right and runs its main path on the GPU.

Phases (one JSON line each, any failure exits nonzero before the last line):

  1. device  -- card name, ``nvidia-smi`` name and power limit; TF32 off for
     every float32 reference.
  2. build   -- compile the CUDA sources of deepatlas_torch/kernels/csrc.
  3. kernels -- each kernel against its plain PyTorch version at every
     shape the UNet_light tile forward launches (batch 4 of 128^3 tiles), in
     float32 and bfloat16, with kernel / plain / library (cuDNN) times from
     CUDA events and the least time the card could take (``bound_ms``).
  4. main    -- the segmentation serving path: a synthetic OAI-ZIB corpus
     (160x384x384 volumes, labels 0..4, from ``--seed``), UNet_light with
     seeded weights and BatchNorm statistics saved as a checkpoint, and
     ``infer_seg_torch.main`` at the documented OAI setting (tile 128^3,
     overlap 16, tile batch 4, bf16).  The launch counters must show 14 k3
     convs, 3 deconvs and 1 head per tile batch, the CLI's Dice lines must
     be finite, and one tile batch through the kernels must agree with the
     same net on the plain versions.

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

TILE = 128
TILE_BATCH = 4
OAI_SHAPE = (160, 384, 384)
N_VOLUMES = 2
N_CLASSES = 5


def log(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def slice_shapes():
    """Every (kernel, input shape, weight shape) a UNet_light tile batch
    launches, with the launches per tile batch."""
    from deepatlas_torch.models import (UNET_LIGHT_DECODERS,
                                        UNET_LIGHT_ENCODERS)

    shapes = {}

    def add(kernel, size, cin, cout):
        key = (kernel, size, cin, cout)
        shapes[key] = shapes.get(key, 0) + 1

    cin, size, skips = 1, TILE, []
    for i, plan in enumerate(UNET_LIGHT_ENCODERS):
        for f in (plan if i == 0 else plan[1:]):
            add("conv3d_k3", size, cin, f)
            cin = f
        if i < len(UNET_LIGHT_ENCODERS) - 1:
            skips.append(cin)
            size //= 2
    for plan in UNET_LIGHT_DECODERS:
        add("deconv2x", size, cin, plan[0])
        size *= 2
        cin = plan[0] + skips.pop()
        for f in plan[1:]:
            add("conv3d_k3", size, cin, f)
            cin = f
    add("conv3d_point", size, cin, N_CLASSES)
    return shapes


def work(kernel, size, cin, cout, dtype_name):
    """(flops, bytes) the function needs: each input read once, each output
    written once (weights as the float32 the kernels read)."""
    n = TILE_BATCH * size ** 3
    s = 2 if dtype_name == "bfloat16" else 4
    if kernel == "conv3d_k3":
        return 2 * 27 * cin * cout * n, n * cin * s + 27 * cin * cout * 4 \
            + n * cout * s
    if kernel == "conv3d_point":
        return 2 * cin * cout * n, n * cin * s + cin * cout * 4 + n * cout * s
    return 2 * 8 * cin * cout * n, n * cin * s + 8 * cin * cout * 4 \
        + 8 * n * cout * s


def bound_ms(kernel, size, cin, cout, dtype_name):
    flops, nbytes = work(kernel, size, cin, cout, dtype_name)
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
    for ``library_ms`` only; the port never calls it."""
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)           # NDHWC storage, NCDHW view
    wk = w.to(x.dtype)
    if kernel == "conv3d_k3":
        return lambda: F.conv3d(xc, wk.permute(4, 3, 0, 1, 2), padding=1)
    if kernel == "conv3d_point":
        return lambda: F.conv3d(xc, wk.permute(1, 0)[:, :, None, None, None])
    return lambda: F.conv_transpose3d(xc, wk.permute(3, 4, 0, 1, 2), stride=2)


def check_kernels(seed):
    """Phase 3: every kernel against its plain version at every slice shape
    in both types.  Returns per-kernel summaries for the final line."""
    import torch

    from deepatlas_torch.kernels import KERNELS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "library_ms": 0.0, "flops": 0,
                      "bytes": 0}
               for name in KERNELS}
    for (name, size, cin, cout), per_batch in slice_shapes().items():
        fn, plain = KERNELS[name]
        wshape = {"conv3d_k3": (3, 3, 3, cin, cout),
                  "deconv2x": (2, 2, 2, cin, cout),
                  "conv3d_point": (cin, cout)}[name]
        fan = cin * (27 if name == "conv3d_k3" else 1)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = (torch.rand((TILE_BATCH, size, size, size, cin),
                            generator=gen, device="cuda") * 2 - 1).to(dtype)
            w = torch.randn(wshape, generator=gen, device="cuda") \
                / np.sqrt(fan)
            bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
            got = fn(x, w, bias)
            ref = plain(x, w, bias)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name} {tuple(x.shape)}: kernel gives "
                                     f"{tuple(got.shape)} {got.dtype}, plain "
                                     f"{tuple(ref.shape)} {ref.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = bool(np.isfinite(err)) and err <= TOL[dname] * scale
            ms = cuda_ms(lambda: fn(x, w), reps=5)
            plain_ms = cuda_ms(lambda: plain(x, w), reps=2)
            lib_ms = cuda_ms(library_call(name, x, w), reps=5)
            bms, bound_by = bound_ms(name, size, cin, cout, dname)
            log({"phase": "kernels", "kernel": name, "dtype": dname,
                 "x": list(x.shape), "w": list(wshape),
                 "launches_per_tile_batch": per_batch,
                 "max_abs_err": err, "max_abs_ref": scale,
                 "rel_tol": TOL[dname], "ok": ok, "kernel_ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms,
                 "bound_ms": bms, "bound_by": bound_by})
            if not ok:
                raise AssertionError(f"{name} {dname} {tuple(x.shape)} -> "
                                     f"{cout}: max|k-p| {err} > "
                                     f"{TOL[dname]} * {scale}")
            s = summary[name]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            if dname == "bfloat16":   # the main path's type, per tile batch
                flops, nbytes = work(name, size, cin, cout, dname)
                s["ms"] += per_batch * ms
                s["plain_ms"] += per_batch * plain_ms
                s["library_ms"] += per_batch * lib_ms
                s["bound_ms"] += per_batch * bms
                s["flops"] += per_batch * flops
                s["bytes"] += per_batch * nbytes
            del x, w, bias, got, ref
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
    want = {"conv3d_k3": 14 * batches, "deconv2x": 3 * batches,
            "conv3d_point": 1 * batches}
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

    summary = check_kernels(args.seed)

    with tempfile.TemporaryDirectory() as workdir:
        counts = run_main_path(args.seed, workdir)

    kernels = []
    for name, s in summary.items():
        src, replaces = KERNEL_INFO[name]
        t_ops = s["flops"] / PEAK_FLOPS["bfloat16"]
        t_bytes = s["bytes"] / HBM_BYTES_PER_S
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": s["library_ms"]})
    print(nvidia_smi(), flush=True)
    log({"kernels": kernels,
         "note": "ms, plain_ms, library_ms and bound_ms are bfloat16 totals "
                 "over one tile batch (4 x 128^3) of UNet_light; "
                 "max_abs_err is the largest over every shape and type"})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
