"""Microbench: the warp kernels E (``warp_trilinear``), F
(``warp_grid_grad``) and G (``splat_trilinear``) at 1x168x200x168, beside
``F.grid_sample`` and the byte bound.

Twin of ``tools/bench_warp.py``, which times the JAX package's Pallas warp
and splat on a TPU.  Three fields, each clamped to ``--max-disp`` voxels as
``kernels.grid_sample`` clamps:

  * ``smooth``: a low-frequency field of up to 2 voxels (a trained field);
  * ``saturated``: the same field scaled to 40 voxels, clamped nearly
    everywhere (an untrained one);
  * ``adversarial``: uniform noise over +-max_disp per voxel (no training
    regime makes it; a lower bound).

Three channel cases, the calls the main paths make: one float32 channel
(the registration image warp and the splat of ones), 32 bfloat16 channels
(the soft anatomy's probabilities) and 32 float32 one-hot channels (the
f-hard branch's splat).  Per kernel and case: ms per call from CUDA events
around ``--iters`` calls after one warm-up (at small shapes the host's time)
and the card's time of the same calls queued behind a spin kernel
(``chip_smoke.cuda_ms(queued=True)``), the most memory the call holds above
its inputs, whether two calls give the same bits, and ``F.grid_sample``'s
forward and backward (grid gradient and values in one call) on the float32
values (a yardstick only: the port never calls it).  ``--seg-step`` also
profiles one joint seg step per label regime at the same size (UNet_light
with 32 classes and VoxelMorph in bfloat16, random weights from
``--seed``): device-busy ms under ``torch.profiler`` and peak memory.

The tool calls only the public wrappers, so ``--repo DIR`` runs it on
another checkout's ``deepatlas_torch`` (an earlier commit unpacked with
``git archive``) for before-and-after runs in one session.  One JSON line
at the end holds every number with the card's ``nvidia-smi`` name and power
limit; ``--out FILE`` appends it to a file as well.  ``--device cpu`` runs
the plain versions at a small ``--size`` for the tests (host clock: no
device numbers).

  python tools/bench_warp_torch.py [--iters 10] [--repo DIR] [--seg-step]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import HBM_BYTES_PER_S, cuda_ms, nvidia_smi, warp_bytes

FIELDS = ("smooth", "saturated", "adversarial")
# (name, channels, values' type, one-hot values and upstream gradient)
CASES = (("c1_float32", 1, "float32", False),
         ("c32_bfloat16", 32, "bfloat16", False),
         ("c32_float32_onehot", 32, "float32", True))
KERNELS = ("warp_trilinear", "warp_grid_grad", "splat_trilinear")


def make_grid(kind, shape, max_disp, gen, device):
    """``(B, D, H, W, 3)`` normalized grid: identity plus the field, clamped
    to ``max_disp`` voxels."""
    import torch

    from deepatlas_torch.ops import (clamp_displacement, identity_grid_batch,
                                     normalize_displacement)

    b, d, h, w = shape
    if kind == "adversarial":
        disp = (torch.rand((b, d, h, w, 3), generator=gen, device=device)
                * 2 - 1) * max_disp
    else:
        zz, yy, xx = torch.meshgrid(
            *[torch.linspace(0, 1, n, device=device) for n in (d, h, w)],
            indexing="ij")
        two_pi = 2 * torch.pi
        base = torch.stack([
            torch.sin(two_pi * (1.3 * xx + 0.7 * yy))
            * torch.cos(two_pi * 0.9 * zz),
            torch.cos(two_pi * (0.8 * yy + 1.1 * zz))
            * torch.sin(two_pi * 0.6 * xx),
            torch.sin(two_pi * (0.5 * zz + 1.2 * xx))
            * torch.cos(two_pi * 0.8 * yy)], dim=-1)[None]
        disp = (2.0 if kind == "smooth" else 40.0) * base.expand(
            b, -1, -1, -1, -1)
    grid = normalize_displacement(disp) + identity_grid_batch(
        (b, d, h, w), device=device)
    return clamp_displacement(grid, max_disp).contiguous()


def case_inputs(shape, c, dtype_name, onehot, gen, device):
    """Values and upstream gradient ``(B, D, H, W, C)``: uniform on [0, 1)
    and [-1, 1), or both one-hot of random blocky labels."""
    import torch

    dtype = getattr(torch, dtype_name)
    if onehot:
        b, d, h, w = shape
        labels = torch.randint(0, c, (b, d // 8 + 1, h // 8 + 1, w // 8 + 1),
                               generator=gen, device=device)
        labels = labels.repeat_interleave(8, 1).repeat_interleave(8, 2) \
            .repeat_interleave(8, 3)[:, :d, :h, :w]
        vol = torch.nn.functional.one_hot(labels, c).to(dtype).contiguous()
        return vol, vol
    vol = torch.rand(shape + (c,), generator=gen, device=device).to(dtype)
    ct = (torch.rand(shape + (c,), generator=gen, device=device) * 2
          - 1).to(dtype)
    return vol, ct


def timer(device):
    """``(ms, device_ms)`` of a call: CUDA events and the queued time on
    the card; the host clock and None on the CPU."""
    if device.type == "cuda":
        return (lambda fn, reps: cuda_ms(fn, reps),
                lambda fn, reps: cuda_ms(fn, reps, queued=True))

    def host_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    return host_ms, lambda fn, reps: None


def held_mb(fn, device):
    """MB the call holds at its peak above what was allocated before it."""
    import torch

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / 2 ** 20


def passes(fn, device):
    """The device kernels one call launches, with their device ms, from
    ``torch.profiler`` (after one warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [{"name": e.key[:60], "ms": getattr(
        e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        / 1e3, "launches": e.count} for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA]


def bench_kernels(args, device):
    import torch
    import torch.nn.functional as F

    from deepatlas_torch import kernels

    ms_of, device_ms_of = timer(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = (1,) + tuple(args.size)
    n = int(torch.tensor(shape).prod())
    rows = []
    for field in args.fields:
        grid = make_grid(field, shape, args.max_disp, gen, device)
        for case, c, dname, onehot in CASES:
            if case not in args.cases:
                continue
            vol, ct = case_inputs(shape, c, dname, onehot, gen, device)
            vol_l = vol.float().permute(0, 4, 1, 2, 3).requires_grad_(True)
            grid_l = grid.clone().requires_grad_(True)
            ct_l = ct.float().permute(0, 4, 1, 2, 3)
            out_l = F.grid_sample(vol_l, grid_l, mode="bilinear",
                                  padding_mode="zeros", align_corners=True)
            library = {
                "forward": lambda: F.grid_sample(
                    vol_l.detach(), grid, mode="bilinear",
                    padding_mode="zeros", align_corners=True),
                "backward": lambda: torch.autograd.grad(
                    out_l, (vol_l, grid_l), ct_l, retain_graph=True)}
            lib = {key: (ms_of(fn, args.iters), device_ms_of(fn, args.iters))
                   for key, fn in library.items()}
            calls = {
                "warp_trilinear": lambda: kernels.warp_trilinear(vol, grid),
                "warp_grid_grad": lambda: kernels.warp_grid_grad(vol, grid,
                                                                 ct),
                "splat_trilinear": lambda: kernels.splat_trilinear(
                    ct, grid, shape[1:])}
            elem = 2 if dname == "bfloat16" else 4
            for name in KERNELS:
                fn = calls[name]
                first, second = fn(), fn()
                same = bool(torch.equal(first, second))
                finite = bool(torch.isfinite(first).all())
                del first, second
                lib_key = "forward" if name == "warp_trilinear" \
                    else "backward"
                row = {"field": field, "case": case, "kernel": name,
                       "channels": c, "dtype": dname,
                       "ms": ms_of(fn, args.iters),
                       "device_ms": device_ms_of(fn, args.iters),
                       "bound_ms": warp_bytes(name, n, c, elem)
                       / HBM_BYTES_PER_S * 1e3,
                       "library": f"F.grid_sample {lib_key} (float32)",
                       "library_ms": lib[lib_key][0],
                       "library_device_ms": lib[lib_key][1],
                       "held_mb": held_mb(fn, device),
                       "passes": passes(fn, device) if args.passes else None,
                       "bit_identical_rerun": same, "finite": finite}
                rows.append(row)
                print(f"{field:>11} {case:>18} {name:>15} "
                      f"ms {row['ms']:9.4f} device "
                      f"{row['device_ms'] if row['device_ms'] is None else round(row['device_ms'], 4)!s:>8} "
                      f"bound {row['bound_ms']:.4f} library "
                      f"{row['library_ms']:.4f} held_mb {row['held_mb']} "
                      f"rerun_same {same}", flush=True)
            del vol, ct, vol_l, grid_l, ct_l, out_l, library, calls
        del grid
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def bench_seg_step(args, device):
    """One joint seg step per label regime: device-busy ms (profiled, after
    two warm steps) and the step's peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepatlas_torch.kernels import grid_sample
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import TrainState, make_joint_seg_step

    torch.manual_seed(args.seed)
    n_class = 32
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    seg = get_network("UNet_light")(in_channel=1, n_classes=n_class,
                                    bias=True, BN=True, dtype=dtype).to(device)
    reg = get_network("voxel_morph_cvpr")(max_disp=args.max_disp,
                                          dtype=dtype).to(device)
    seg_state = TrainState(seg, torch.optim.SGD(seg.parameters(), lr=0.0))
    reg_state = TrainState(reg, torch.optim.SGD(reg.parameters(), lr=0.0))
    step = make_joint_seg_step(
        get_loss_function("dice")(n_class=n_class, weight_type="Uniform",
                                  no_bg=False, softmax=True, eps=1e-6),
        3.0, 1.0, n_class, warp_fn=lambda v, g: grid_sample(
            v, g, max_disp=args.max_disp, grad="values"),
        anatomy_dtype=dtype, hard_fused=True, max_disp=args.max_disp)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = (1,) + tuple(args.size)
    images = [torch.rand(shape + (1,), generator=gen, device=device) * 0.1
              for _ in range(2)]
    labels = [torch.randint(0, n_class, shape, generator=gen, device=device)
              for _ in range(2)]
    saved = {k: v.clone() for k, v in seg.state_dict().items()}

    def run(am, af):
        step(seg_state, reg_state, *images, *labels, torch.tensor([am]),
             torch.tensor([af]))
        seg.load_state_dict(saved)
        seg_state.optimizer.zero_grad(set_to_none=True)

    out = {}
    for i, regime in enumerate(("soft", "f_hard", "m_hard", "hard")):
        am, af = bool(i // 2), bool(i % 2)
        for _ in range(2):
            run(am, af)
        if device.type != "cuda":
            t0 = time.perf_counter()
            run(am, af)
            out[regime] = {"host_ms": (time.perf_counter() - t0) * 1e3,
                           "device_busy_ms": None, "peak_mb": None}
            continue
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(am, af)
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        busy_us = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        out[regime] = {"host_ms": host_ms, "device_busy_ms": busy_us / 1e3,
                       "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
        print(f"seg step {regime:>6}: {out[regime]}", flush=True)
    return out


def main(argv=None):
    """Print the rows; return the JSON object of the last line."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--size", type=int, nargs=3, default=[168, 200, 168])
    ap.add_argument("--max-disp", type=int, default=8)
    ap.add_argument("--fields", nargs="+", default=list(FIELDS),
                    choices=FIELDS)
    ap.add_argument("--cases", nargs="+", default=[c[0] for c in CASES],
                    choices=[c[0] for c in CASES])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repo", default=ROOT,
                    help="checkout whose deepatlas_torch to time")
    ap.add_argument("--label", default="", help="tag of the run in the JSON")
    ap.add_argument("--seg-step", action="store_true")
    ap.add_argument("--passes", action="store_true",
                    help="profile each call's device kernels")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    import deepatlas_torch
    from deepatlas_torch import resolve_device

    if os.path.dirname(os.path.dirname(os.path.abspath(
            deepatlas_torch.__file__))) != repo:
        raise RuntimeError(f"deepatlas_torch came from "
                           f"{deepatlas_torch.__file__}, not {repo}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi() if device.type == "cuda" else None
    print(f"{smi or 'cpu: host clock, no device numbers'}; repo {repo}",
          flush=True)
    result = {"tool": "bench_warp_torch", "label": args.label,
              "repo": repo, "device": device.type,
              "name": torch.cuda.get_device_name(0)
              if device.type == "cuda" else None, "nvidia_smi": smi,
              "size": list(args.size), "iters": args.iters,
              "rows": bench_kernels(args, device)}
    if args.seg_step:
        result["seg_step"] = bench_seg_step(args, device)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
