"""Per-shape roofline of the port's conv kernels on UNet_light's forward.

Twin of ``tools/bench_packed_conv.py``, which times the JAX package's
packed Pallas kernels on a TPU.  ``collect_shapes`` records every call the
port's UNet_light forward (32 classes, bf16, train mode, one volume of the
MindBoggle recipe size) makes to kernels A (``conv3d_k3``), B
(``conv3d_point``) and C (``deconv2x``), in call order; the forward runs on
the ``meta`` device with the wrappers that ``models/layers.py`` and
``models/unet.py`` call replaced by recorders, so no conv runs.  Each unique
shape is then timed in bfloat16 on random inputs from ``--seed`` and gets
one row:

  * true MACs (the convolution's arithmetic),
  * HBM bytes (operands in x's type: input + output + weights, each once),
  * measured ms (CUDA events over ``--iters`` launches after one warm-up),
  * achieved TF/s, and the bound ``max(flops / 989e12, bytes / 3.35e12)``
    in ms (H100 SXM, dense bf16, the constants of ``chip_smoke.py``).

With ``--step-ms`` it prints a segmentation training step's share of the
bf16 peak, taking the step's conv flops as 3x the forward's (the input and
weight gradients).  ``--device cpu`` runs the census and the calls on the
CPU (the plain versions, host clock) for the tests: its times are no device
numbers.  The card's ``nvidia-smi`` name and power limit head the table.

With ``--before-after`` it also times, per k3 shape and on the same bf16
inputs, in turns (tensor core, CUDA core, cuDNN, then the same in reverse,
each time the mean of both): kernel A as the wrapper launches it in bf16
(the tensor-core kernel of ``csrc/conv3d_mma.cu``), the CUDA-core kernel A
of ``csrc/conv3d.cu`` called through its C entry point, and cuDNN's
``F.conv3d`` (a yardstick only: the port never calls it); then the same
three for kernel D (``conv3d_k3_wgrad``, ``csrc/conv3d_wgrad.cu``,
``torch.nn.grad.conv3d_weight``) at UNet_light's weight-gradient shapes
(each k3 conv's input and an upstream gradient of its output's shape);
then the same three for kernel C (``deconv2x``: the tensor-core kernel of
``csrc/channel_mix_mma.cu``, the CUDA-core kernel of ``csrc/deconv3d.cu``,
``F.conv_transpose3d``) and kernel B (``conv3d_point``: the same tensor-core
source, ``csrc/conv3d.cu``, ``F.conv3d``) at UNet_light's forward shapes,
each also timed queued (the stream held by a spin kernel while the host
enqueues the calls: the card's time without the host's launch overhead,
which the event times of the smaller shapes hold).
The tensor-core results are held against the CUDA-core ones (A, B and C
within one bf16 rounding, 1e-2 of the range; D within 1e-4, both sum exact
bf16 products in float32); a mismatch fails the run.  On the CPU the
CUDA-core column and the queued times are empty.

  python tools/bench_packed_conv_torch.py [--iters 10] [--step-ms 152.3]
      [--before-after]
  python tools/bench_packed_conv_torch.py --device cpu --size 8 16 24 \\
      --n-classes 4 --iters 1
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from chip_smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, TOL, bound_ms, cuda_ms,
                        library_call, nvidia_smi)

PEAK = PEAK_FLOPS["bfloat16"]


def collect_shapes(size, n_classes):
    """``[(kind, x_shape, w_shape, kwargs)]`` of every call UNet_light's
    forward on a ``(1, *size, 1)`` volume makes to ``conv3d_k3``,
    ``conv3d_point`` and ``deconv2x`` (``kind`` is the wrapper's name), in
    call order.  Nothing is computed: the model lives on the ``meta``
    device and each recorder returns an empty tensor of the call's output
    shape."""
    import torch

    import deepatlas_torch.models.layers as layers
    import deepatlas_torch.models.unet as unet
    from deepatlas_torch.kernels.conv3d import strided_shape
    from deepatlas_torch.models import UNetLight

    calls = []

    def recorder(kind, out_shape):
        def record(x, w, **kwargs):
            calls.append((kind, tuple(x.shape), tuple(w.shape), kwargs))
            return x.new_empty(out_shape(x, w, **kwargs))
        return record

    conv = recorder("conv3d_k3", lambda x, w, stride=1: (
        x.shape[0], *strided_shape(x.shape[1:4], stride), w.shape[-1]))
    point = recorder("conv3d_point",
                     lambda x, w: (*x.shape[:-1], w.shape[-1]))
    deconv = recorder("deconv2x", lambda x, w: (
        x.shape[0], *(2 * n for n in x.shape[1:4]), w.shape[-1]))
    with mock.patch.object(layers, "conv3d_k3", conv), \
            mock.patch.object(layers, "deconv2x", deconv), \
            mock.patch.object(unet, "conv3d_point", point), \
            torch.device("meta"):
        model = UNetLight(in_channel=1, n_classes=n_classes, bias=True,
                          BN=True, dtype=torch.bfloat16)
        model(torch.empty(1, *size, 1), train=True)
    return calls


def unique_shapes(calls):
    """``{(kind, x_shape, w_shape, kwargs items): calls per forward}`` in
    first-call order."""
    uniq = {}
    for kind, xs, ws, kw in calls:
        key = (kind, xs, ws, tuple(sorted(kw.items())))
        uniq[key] = uniq.get(key, 0) + 1
    return uniq


def analyze(kind, x_shape, w_shape, kwargs, elem=2):
    """(true MACs, HBM bytes) of one call, operands ``elem`` bytes each:
    the input and the weights read once, the output written once."""
    vox = int(np.prod(x_shape[:4]))
    cin, cout = w_shape[-2], w_shape[-1]
    if kind == "conv3d_k3":
        stride = kwargs.get("stride", 1)
        out = x_shape[0] * int(np.prod([-(-n // stride)
                                        for n in x_shape[1:4]]))
        return out * 27 * cin * cout, \
            elem * (vox * cin + out * cout + 27 * cin * cout)
    if kind == "conv3d_point":
        return vox * cin * cout, elem * (vox * (cin + cout) + cin * cout)
    return vox * 8 * cin * cout, \
        elem * (vox * cin + 8 * vox * cout + 8 * cin * cout)


def bound(macs, nbytes):
    """(least ms on an H100 in bf16, what bounds it)."""
    t_ops, t_bytes = 2 * macs / PEAK * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def timer(device):
    """ms per call of ``fn`` over ``iters`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        return lambda fn, iters: cuda_ms(fn, iters)

    def host_ms(fn, iters):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    return host_ms


def header(device) -> str:
    if device.type == "cuda":
        return nvidia_smi()
    return "cpu: plain versions on the host clock, not device times"


def inputs(kind, x_shape, w_shape, device, gen):
    """bf16 x in [-1, 1) and float32 weights scaled by 1/sqrt(fan-in)."""
    import torch

    x = (torch.rand(x_shape, generator=gen, device=device) * 2 - 1).to(
        torch.bfloat16)
    fan = w_shape[-2] * (27 if kind == "conv3d_k3" else 1)
    w = torch.randn(w_shape, generator=gen, device=device) / np.sqrt(fan)
    return x, w


def in_turns(fns, ms_of, iters):
    """ms per call of each of ``fns`` (None: not timed), timed in the order
    given and then in reverse, each the mean of its two readings."""
    first = [None if f is None else ms_of(f, iters) for f in fns]
    second = [None if f is None else ms_of(f, iters)
              for f in reversed(fns)][::-1]
    return [None if a is None else (a + b) / 2 for a, b in zip(first, second)]


def _fmt(ms):
    return f"{'-':>8}" if ms is None else f"{ms:8.3f}"


def before_after(uniq, device, ms_of, iters, gen, made):
    """Kernels A, D, C and B in bf16 per shape: the tensor-core kernel
    (through its wrapper, counted in ``made``), the CUDA-core kernel
    (through its C entry point; on the card only) and cuDNN, timed in turns
    and held against each other; C and B also queued (on the card only).
    Returns ``{"conv3d_k3": rows, "conv3d_k3_wgrad": rows, "deconv2x":
    rows, "conv3d_point": rows, "totals"}``, totals weighted by calls per
    forward (every k3 conv of a training step has one weight gradient)."""
    import torch

    from deepatlas_torch.kernels import (conv3d, conv3d_k3, conv3d_k3_wgrad,
                                         conv3d_point, deconv2x, deconv3d)

    on_card = device.type == "cuda"
    queued = (lambda fn, n: cuda_ms(fn, n, queued=True)) if on_card else None
    made["conv3d_k3_wgrad"] = 0
    out = {"conv3d_k3": [], "conv3d_k3_wgrad": [], "deconv2x": [],
           "conv3d_point": []}
    print(f"before/after, bf16, ms per call: tensor core (wrapper) | CUDA "
          f"core (C entry point) | cuDNN | bound; C and B queued: tensor "
          f"core | CUDA core | cuDNN", flush=True)

    def counted(name, fn):
        def call():
            made[name] += 1
            return fn()
        return call

    for (kind, xs, ws, kwt), n in uniq.items():
        x, w = inputs(kind, xs, ws, device, gen)
        wk = w.to(torch.bfloat16).float()
        nvox, cin, cout = int(np.prod(xs[:4])), ws[-2], ws[-1]
        if kind == "conv3d_k3":
            g = (torch.rand(xs[:4] + (ws[-1],), generator=gen, device=device)
                 * 2 - 1).to(torch.bfloat16)
            cases = (
                ("conv3d_k3", counted("conv3d_k3", lambda: conv3d_k3(x, w)),
                 lambda: conv3d._k3_simt(x, wk, None),
                 library_call("conv3d_k3", x, w), TOL["bfloat16"], False),
                ("conv3d_k3_wgrad",
                 counted("conv3d_k3_wgrad", lambda: conv3d_k3_wgrad(x, g)),
                 lambda: conv3d._wgrad_simt(x, g),
                 library_call("conv3d_k3_wgrad", x, g), TOL["float32"],
                 False))
        elif kind == "deconv2x":
            cases = (("deconv2x", counted("deconv2x", lambda: deconv2x(x, w)),
                      lambda: deconv3d._deconv_simt(x, wk, None),
                      library_call("deconv2x", x, w), TOL["bfloat16"],
                      True),)
        else:
            cases = (("conv3d_point",
                      counted("conv3d_point", lambda: conv3d_point(x, w)),
                      lambda: conv3d._point_simt(x, wk.reshape(cin, cout),
                                                 None),
                      library_call("conv3d_point", x, w.reshape(cin, cout)),
                      TOL["bfloat16"], True),)
        for name, tc, simt, lib, tol, timed_queued in cases:
            err = None
            if on_card:
                a, b = tc().float(), simt().float()
                err = (a - b).abs().max().item()
                if not err <= tol * b.abs().max().item():
                    raise AssertionError(
                        f"{name} {xs} -> {cout}: tensor core and CUDA core "
                        f"differ by {err} > {tol} * {b.abs().max().item()}")
                del a, b
            tc_ms, simt_ms, lib_ms = in_turns(
                [tc, simt if on_card else None, lib], ms_of, iters)
            tc_q = simt_q = lib_q = None
            if timed_queued and on_card:
                tc_q, simt_q, lib_q = in_turns([tc, simt, lib], queued, iters)
            bms, by = bound_ms(name, nvox, cin, cout, "bfloat16")
            out[name].append({"x": list(xs), "cin": cin, "cout": cout,
                              "n": n, "tensor_core_ms": tc_ms,
                              "cuda_core_ms": simt_ms, "library_ms": lib_ms,
                              "tensor_core_device_ms": tc_q,
                              "cuda_core_device_ms": simt_q,
                              "library_device_ms": lib_q,
                              "bound_ms": bms, "bound_by": by,
                              "max_abs_diff_tc_vs_cuda_core": err})
            queued_cols = (f" | queued {_fmt(tc_q)} | {_fmt(simt_q)} | "
                           f"{_fmt(lib_q)}" if timed_queued else "")
            print(f"{name:15} {str(xs):>24} {f'{cin}->{cout}':>7} {n:>2} | "
                  f"{_fmt(tc_ms)} | {_fmt(simt_ms)} | {_fmt(lib_ms)} | "
                  f"{bms:7.4f}{queued_cols}", flush=True)
        del x, w, wk, cases, tc, simt, lib
    totals = {}
    for name, rows in out.items():
        totals[name] = {
            key: (None if any(r[key] is None for r in rows)
                  else sum(r["n"] * r[key] for r in rows))
            for key in ("tensor_core_ms", "cuda_core_ms", "library_ms",
                        "bound_ms", "tensor_core_device_ms",
                        "cuda_core_device_ms", "library_device_ms")}
        t = totals[name]
        print(f"{name:15} {'total':>24} {'':>7} "
              f"{sum(r['n'] for r in rows):>2} | {_fmt(t['tensor_core_ms'])} "
              f"| {_fmt(t['cuda_core_ms'])} | {_fmt(t['library_ms'])} | "
              f"{t['bound_ms']:7.4f}", flush=True)
    out["totals"] = totals
    return out


def main(argv=None):
    """Print the table; return ``{"device", "rows", "calls", "fwd_flops",
    "fwd_ms", "fwd_bound_ms"}`` (and ``"before_after"`` with
    ``--before-after``) where ``calls`` counts the wrapper calls made here
    per kernel (each one launch on the card)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, nargs=3, default=[168, 200, 168])
    ap.add_argument("--n-classes", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-ms", type=float, default=None,
                    help="measured seg step ms (tools/"
                         "profile_seg_step_torch.py) for the peak share")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--before-after", action="store_true",
                    help="also time kernels A, D, C and B in bf16 on the "
                         "tensor cores, on the CUDA cores and in cuDNN, per "
                         "shape")
    args = ap.parse_args(argv)

    import torch

    from deepatlas_torch import kernels, resolve_device

    device = resolve_device(args.device)
    ms_of = timer(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    calls = collect_shapes(args.size, args.n_classes)
    uniq = unique_shapes(calls)
    made = dict.fromkeys(("conv3d_k3", "conv3d_point", "deconv2x"), 0)
    print(header(device), flush=True)
    print(f"{len(calls)} kernel calls, {len(uniq)} unique shapes (forward, "
          f"size {list(args.size)}, bf16, {device.type})", flush=True)
    print(f"{'kernel':13} {'x (B,D,H,W,C)':>24} {'w':>18} {'n':>2} "
          f"{'GMAC':>7} {'MB':>8} {'ms':>8} {'TF/s':>6} {'bound ms':>9} "
          f"{'by':>5} {'x bound':>8}", flush=True)
    rows = []
    with torch.no_grad():
        for (kind, xs, ws, kwt), n in uniq.items():
            kw = dict(kwt)
            macs, nbytes = analyze(kind, xs, ws, kw)
            x, w = inputs(kind, xs, ws, device, gen)
            fn = getattr(kernels, kind)

            def run(fn=fn, x=x, w=w, kw=kw, kind=kind):
                made[kind] += 1
                return fn(x, w, **kw)

            ms = ms_of(run, args.iters)
            bms, by = bound(macs, nbytes)
            rows.append({"kernel": kind, "x": list(xs), "w": list(ws),
                         "kwargs": kw, "n": n, "macs": macs,
                         "bytes": nbytes, "ms": ms,
                         "tflops": 2 * macs / ms / 1e9, "bound_ms": bms,
                         "bound_by": by})
            # a rate or a share of the card's bound only from the card
            rate, share = (f"{2 * macs / ms / 1e9:6.2f}", f"{ms / bms:8.1f}") \
                if device.type == "cuda" else (f"{'-':>6}", f"{'-':>8}")
            print(f"{kind:13} {str(xs):>24} {str(ws):>18} {n:>2} "
                  f"{macs / 1e9:7.2f} {nbytes / 1e6:8.2f} {ms:8.3f} "
                  f"{rate} {bms:9.4f} {by[:5]:>5} {share}", flush=True)
            del x, w
    fwd_flops = sum(2 * r["macs"] * r["n"] for r in rows)
    fwd_ms = sum(r["ms"] * r["n"] for r in rows)
    fwd_bound = sum(r["bound_ms"] * r["n"] for r in rows)
    print(f"forward: {fwd_flops / 1e12:.4f} TF of true conv flops in "
          f"{fwd_ms:.3f} ms over {len(calls)} calls; bound {fwd_bound:.4f} "
          f"ms", flush=True)
    if args.step_ms:
        share = 3 * fwd_flops / (args.step_ms * 1e-3) / PEAK * 100
        print(f"seg step share of the bf16 peak (3 x forward conv flops / "
              f"{args.step_ms} ms / {PEAK / 1e12:.0f} TF/s): {share:.2f}%",
              flush=True)
    result = {"device": device.type, "rows": rows, "calls": made,
              "fwd_flops": fwd_flops, "fwd_ms": fwd_ms,
              "fwd_bound_ms": fwd_bound}
    if args.before_after:
        with torch.no_grad():
            result["before_after"] = before_after(uniq, device, ms_of,
                                                  args.iters, gen, made)
    return result


if __name__ == "__main__":
    main()
