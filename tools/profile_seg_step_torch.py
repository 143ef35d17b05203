#!/usr/bin/env python
"""Where one training step of deepatlas_torch spends its time on the card:
a ``torch.profiler`` trace of a few warm steps at a training recipe's full
width, summed by device kernel.  ``--path seg`` (default) is the
segmentation step (UNet_light, 32 classes, bf16, one 168x200x168 volume,
dice, Adam); ``--path reg`` the registration step (VoxelMorph-CVPR2018 in
bf16 with a float32 flow and warp clamped to 8 voxels, one 168x200x168 pair,
LNCC-9 + bending energy, Adam).

Prints one JSON object: the card (``nvidia-smi`` name and power limit),
seconds per step on the host clock, device-busy milliseconds per step and
the idle share, and the kernels by device time with their launches per
step.  The batch is synthetic and made on the device from ``--seed`` (no
files, no loader), so the numbers are the step's own.  Needs a CUDA device.

  python tools/profile_seg_step_torch.py [--path seg|reg] [--steps 5] [--top 25]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

SHAPE = (168, 200, 168)
N_CLASSES = 32


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--path", choices=("seg", "reg"), default="seg")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepatlas_torch import resolve_device
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import get_network
    from deepatlas_torch.train import (TrainState, make_optimizer,
                                       make_reg_train_step,
                                       make_seg_train_step)
    from deepatlas_torch.utils import sync

    device = resolve_device("cuda")
    torch.manual_seed(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.path == "seg":
        # blocky labels with an intensity that follows them
        coarse = torch.randint(0, N_CLASSES, (1, 21, 25, 21), generator=gen,
                               device=device)
        labels = coarse.repeat_interleave(8, 1).repeat_interleave(
            8, 2).repeat_interleave(8, 3).to(torch.uint8)
        images = ((labels.float() + 1) / (N_CLASSES + 1)
                  + 0.005 * torch.randn(labels.shape, generator=gen,
                                        device=device))[..., None]
        batch = (images, labels)
        model = get_network("UNet_light")(in_channel=1, n_classes=N_CLASSES,
                                          bias=True, BN=True,
                                          dtype=torch.bfloat16).to(device)
        make_step = make_seg_train_step(get_loss_function("dice")(
            n_class=N_CLASSES, weight_type="Uniform", no_bg=False,
            softmax=True, eps=1e-6))
    else:
        # one low-intensity texture and a copy shifted by two voxels (an
        # untrained VoxelMorph's field is proportional to its input)
        zz, yy, xx = torch.meshgrid(*[torch.arange(n, device=device,
                                                   dtype=torch.float32)
                                      for n in SHAPE], indexing="ij")
        fixed = (0.15 + 0.05 * (torch.sin(zz / 4.1) * torch.cos(yy / 3.7)
                                + torch.sin(xx / 5.3)))[None, ..., None]
        batch = (torch.roll(fixed, (2, -2, 1), (1, 2, 3)).contiguous(), fixed)
        model = get_network("voxel_morph_cvpr")(
            max_disp=8, dtype=torch.bfloat16).to(device)
        make_step = make_reg_train_step(
            get_loss_function("lncc")(filter_size=9),
            get_loss_function("bendingEnergy")(), 1.0, max_disp=8)
    state = TrainState(model, make_optimizer(model, 1e-3))

    def step():
        out = make_step(state, *batch)[1]
        return out["loss"] if isinstance(out, dict) else out

    for _ in range(3):                          # build, warm up
        loss = step()
    sync(device)

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            loss = step()
        sync(device)
    traced_s = (time.perf_counter() - t0) / args.steps

    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step()
    sync(device)
    step_s = (time.perf_counter() - t0) / args.steps

    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0))

    # device-side events only: an operator's row repeats the time of the
    # kernels it launched
    rows = [(device_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        print("the profiler reported no device time", file=sys.stderr)
        return 1
    rows.sort(reverse=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    busy_ms = busy_us / 1e3 / args.steps
    print(json.dumps({
        "card": smi, "torch": torch.__version__, "path": args.path,
        "shape": SHAPE, "steps": args.steps, "loss": float(loss),
        "step_s": step_s, "step_s_while_traced": traced_s,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / 1e3 / step_s),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "kernels": [{"name": key[:100], "ms_per_step": us / 1e3 / args.steps,
                     "share_of_busy": us / busy_us,
                     "launches_per_step": count / args.steps}
                    for us, count, key in rows[:args.top]],
        "other_kernels_ms_per_step":
            sum(r[0] for r in rows[args.top:]) / 1e3 / args.steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
