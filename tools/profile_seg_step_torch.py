#!/usr/bin/env python
"""Where one segmentation training step of deepatlas_torch spends its time
on the card: a ``torch.profiler`` trace of a few warm steps at the training
recipe's full width (UNet_light, 32 classes, bf16, one 168x200x168 volume,
dice, Adam), summed by device kernel.

Prints one JSON object: the card (``nvidia-smi`` name and power limit),
seconds per step on the host clock, device-busy milliseconds per step and
the idle share, and the kernels by device time with their launches per
step.  The batch is synthetic and made on the device from ``--seed`` (no
files, no loader), so the numbers are the step's own.  Needs a CUDA device.

  python tools/profile_seg_step_torch.py [--steps 5] [--top 25]
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
                                       make_seg_train_step)
    from deepatlas_torch.utils import sync

    device = resolve_device("cuda")
    torch.manual_seed(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    # blocky labels with an intensity that follows them
    coarse = torch.randint(0, N_CLASSES, (1, 21, 25, 21), generator=gen,
                           device=device)
    labels = coarse.repeat_interleave(8, 1).repeat_interleave(
        8, 2).repeat_interleave(8, 3).to(torch.uint8)
    images = ((labels.float() + 1) / (N_CLASSES + 1)
              + 0.005 * torch.randn(labels.shape, generator=gen,
                                    device=device))[..., None]

    model = get_network("UNet_light")(in_channel=1, n_classes=N_CLASSES,
                                      bias=True, BN=True,
                                      dtype=torch.bfloat16).to(device)
    state = TrainState(model, make_optimizer(model, 1e-3))
    step = make_seg_train_step(get_loss_function("dice")(
        n_class=N_CLASSES, weight_type="Uniform", no_bg=False, softmax=True,
        eps=1e-6))

    for _ in range(3):                          # build, warm up
        state, loss, _ = step(state, images, labels)
    sync(device)

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, loss, _ = step(state, images, labels)
        sync(device)
    traced_s = (time.perf_counter() - t0) / args.steps

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss, _ = step(state, images, labels)
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
        "card": smi, "torch": torch.__version__, "shape": SHAPE,
        "n_classes": N_CLASSES, "steps": args.steps, "loss": float(loss),
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
