"""Time and check the unit-stride 9^3 window sums of LNCC on the card.

    python tools/bench_window_sum_torch.py [--shape 168 200 168] \
        [--reps 20] [--out window_sum.jsonl]

Ways to take the separable window sum of a ``(1, D, H, W, 1)`` float32
volume, each timed with CUDA events (the median of ``--reps`` calls after
three warm-up calls): the window sum alone forward, forward and backward,
and the whole ``lncc_loss`` (five window sums) forward and backward with
that window sum in it.

* ``prefix32``: float32 prefix sums over whole axes and one difference;
* ``port``: ``deepatlas_torch.ops.window_sum`` as it stands (sums by
  doubling: 2, 4, 8 neighbours, then the window, four adds an axis; its
  backward the same sums over the gradient padded by ``k - 1`` on each
  side, the adjoint of a valid box filter);
* ``prefix64``: float64 prefix sums, the differences cast back;
* ``slices``: the sum of ``k`` shifted slices per axis;
* ``blocked``: prefix and suffix sums inside blocks of ``k`` (van Herk /
  Gil-Werman), each window the suffix of one block and the prefix of the
  next, so that no partial sum spans more than the window;
* ``doubling``: the port's sums by doubling under autograd's own backward
  (a zero-filled copy of each slice's gradient).

Each is checked on a zero-background brain pair of that shape (an ellipsoid
of noisy intensities, the moving side leaking a thousandth of its edge into
the background, as a near-identity trilinear warp does): the LNCC value
and the moving image's gradient against the same loss in float64.  Prints
one JSON line per way and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepatlas_torch.losses import similarity  # noqa: E402
from deepatlas_torch.ops import window_sum  # noqa: E402
from deepatlas_torch.ops.window import _doubling_sum  # noqa: E402


def prefix32(x, k):
    out = x
    for axis in (1, 2, 3):
        n = out.shape[axis]
        cs = torch.cumsum(out, dim=axis)
        cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs],
                       dim=axis)
        out = cs.narrow(axis, k, n + 1 - k) - cs.narrow(axis, 0, n + 1 - k)
    return out


def prefix64(x, k):
    out = x
    for axis in (1, 2, 3):
        n = out.shape[axis]
        cs = torch.cumsum(out, dim=axis, dtype=torch.float64)
        cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs],
                       dim=axis)
        out = (cs.narrow(axis, k, n + 1 - k)
               - cs.narrow(axis, 0, n + 1 - k)).to(x.dtype)
    return out


def slices(x, k):
    out = x
    for axis in (1, 2, 3):
        m = out.shape[axis] - k + 1
        acc = out.narrow(axis, 0, m)
        for j in range(1, k):
            acc = acc + out.narrow(axis, j, m)
        out = acc
    return out


def blocked(x, k):
    out = x
    for axis in (1, 2, 3):
        n = out.shape[axis]
        nb = -(-n // k)
        xb = F.pad(out, [0, 0] * (out.dim() - 1 - axis) + [0, nb * k - n])
        xb = xb.reshape(xb.shape[:axis] + (nb, k) + xb.shape[axis + 1:])
        p = torch.cumsum(xb, dim=axis + 1)
        s = torch.cumsum(xb.flip(axis + 1), dim=axis + 1).flip(axis + 1)
        # a block's prefix without its last entry (that is a whole block)
        q = torch.cat([p.narrow(axis + 1, 0, k - 1),
                       torch.zeros_like(p.narrow(axis + 1, 0, 1))],
                      dim=axis + 1)
        flat = out.shape[:axis] + (nb * k,) + out.shape[axis + 1:]
        m = n - k + 1
        out = s.reshape(flat).narrow(axis, 0, m) \
            + q.reshape(flat).narrow(axis, k - 1, m)
    return out


def doubling(x, k):
    for axis in (1, 2, 3):
        x = _doubling_sum(x, axis, k)
    return x


WAYS = {"prefix32": prefix32, "port": lambda x, k: window_sum(x, k),
        "prefix64": prefix64, "slices": slices, "blocked": blocked,
        "doubling": doubling}


def brain_pair(shape, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    d, h, w = shape
    axes = [torch.linspace(-1, 1, n) for n in shape]
    r2 = (axes[0][:, None, None] / 0.85) ** 2 \
        + (axes[1][None, :, None] / 0.88) ** 2 \
        + (axes[2][None, None, :] / 0.9) ** 2
    inside = (r2 <= 1.0).double()

    def brain():
        blocks = torch.rand(4, 4, 2, generator=g, dtype=torch.float64)
        up = blocks[torch.arange(d) * 4 // d][:, torch.arange(h) * 4 // h][
            :, :, torch.arange(w) * 2 // w]
        img = (0.4 + 0.5 * up + 0.05 * torch.randn(
            d, h, w, generator=g, dtype=torch.float64)) * inside
        return img.clamp(0, 1)

    fixed, moving = brain(), brain()
    for ax in range(3):      # a near-identity trilinear warp's edge
        moving = 0.999 * moving + 0.001 * torch.roll(moving, 1, ax)
    return (t[None, ..., None].to(device) for t in (moving, fixed))


def event_ms(fn, reps):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def lncc_with(way, moving, fixed):
    keep = similarity.window_sum
    similarity.window_sum = lambda x, w, s=1, d=1: WAYS[way](x, w)
    try:
        m = moving.detach().requires_grad_(True)
        loss = similarity.lncc_loss(m, fixed, filter_size=9)
        loss.backward()
        return loss.detach(), m.grad
    finally:
        similarity.window_sum = keep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=[168, 200, 168])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="window_sum.jsonl")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    moving, fixed = brain_pair(args.shape, dev)
    v64, g64 = lncc_with("slices", moving, fixed)
    m32, f32 = moving.float(), fixed.float()
    x = torch.rand(1, *args.shape, 1, device=dev)
    ct = torch.rand(1, *(n - 8 for n in args.shape), 1, device=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as out:
        for way, fn in WAYS.items():
            xg = x.clone().requires_grad_(True)

            def fwd_bwd():
                xg.grad = None
                fn(xg, 9).backward(ct)

            with torch.no_grad():
                fwd = event_ms(lambda: fn(x, 9), args.reps)
            both = event_ms(fwd_bwd, args.reps)
            lncc = event_ms(lambda: lncc_with(way, m32, f32), args.reps)
            val, grad = lncc_with(way, m32, f32)
            line = {"way": way, "shape": args.shape, "device": smi,
                    "window_sum_fwd_ms": fwd,
                    "window_sum_fwd_bwd_ms": both,
                    "lncc_fwd_bwd_ms": lncc,
                    "lncc_value_gap": abs(float(val) - float(v64)),
                    "grad_rel_err": float((grad.double() - g64).norm()
                                          / g64.norm()),
                    "grad_norm_ratio": float(grad.double().norm()
                                             / g64.norm())}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
