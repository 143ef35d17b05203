"""Microbench: kernel K (``conv3d_k3_block``, ``p_blk`` output planes per
block) against kernel A (``conv3d_k3``) on every k3 conv shape of
UNet_light's forward.

Twin of ``tools/bench_block_conv.py``, which times the JAX package's
multi-plane Pallas kernel against its one-plane kernel on a TPU.  For every
unique k3 shape that ``collect_shapes`` (``tools/bench_packed_conv_torch.py``)
finds, it times in bfloat16, on random inputs from ``--seed``, in turns
(``in_turns``: in order, then in reverse, each the mean of its two
readings): kernel K at each ``--p-blks`` value as the wrapper launches it
(on the tensor cores, ``csrc/conv3d_mma.cu``), the CUDA-core kernel K of
``csrc/conv3d_block.cu`` through its C entry point at the same values,
kernel A, and cuDNN's ``F.conv3d`` of the same conv (a yardstick only: the
port never calls it), each with CUDA events over ``--iters`` launches after
one warm-up.  K is held against A on both routes at every ``p_blk`` (both
round one float32 sum to bf16: within 1e-2 of A's largest output, as in
``chip_smoke.py``); a mismatch or any error fails the run.  Each row also
holds a SHA-256 of A's output, so that two checkouts' runs show whether A
changed a bit.  ``--repo DIR`` runs the tool on another checkout's
``deepatlas_torch`` (``git archive <commit> | tar -x -C tmp/parent``;
``tmp/`` is git-ignored) for parent-change-change-parent runs in one call;
a checkout without the CUDA-core entry leaves that column empty.
``--device cpu`` runs the same calls on the CPU (the plain versions and the
CPU's ``F.conv3d``, host clock) for the tests: its times are no device
numbers.

  python tools/bench_block_conv_torch.py [--iters 10] [--p-blks 2 4 8]
      [--repo DIR] [--label TAG] [--out FILE]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_packed_conv_torch import (analyze, bound, collect_shapes, header,
                                     in_turns, inputs, timer, unique_shapes)
from chip_smoke import TOL, library_call


def _fmt(ms):
    return f"{'-':>8}" if ms is None else f"{ms:8.3f}"


def main(argv=None):
    """Print the table; return ``{"device", "rows", "calls", "totals"}``:
    per shape A's, K's (per ``p_blk``, on the tensor cores through the
    wrapper and on the CUDA cores through the C entry point) and the
    library's ms, K's largest difference from A, A's output digest, the
    bound; ``calls`` counts the wrapper calls made here per kernel (each
    one launch on the card; the C entry point's are not wrapper calls);
    ``totals`` weights each shape by its calls per forward."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--size", type=int, nargs=3, default=[168, 200, 168])
    ap.add_argument("--n-classes", type=int, default=32)
    ap.add_argument("--p-blks", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repo", default=None,
                    help="checkout whose deepatlas_torch to time")
    ap.add_argument("--label", default="", help="tag of the run in the JSON")
    ap.add_argument("--out", default=None,
                    help="append the result as one JSON line to this file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.repo is not None:
        repo = os.path.abspath(args.repo)
        sys.path.insert(0, repo)
    import torch

    import deepatlas_torch
    from deepatlas_torch import resolve_device
    from deepatlas_torch.kernels import conv3d, conv3d_k3, conv3d_k3_block
    from deepatlas_torch.kernels.conv3d import kernel_operands

    if args.repo is not None and os.path.dirname(os.path.dirname(
            os.path.abspath(deepatlas_torch.__file__))) != repo:
        raise RuntimeError(f"deepatlas_torch came from "
                           f"{deepatlas_torch.__file__}, not {repo}")
    device = resolve_device(args.device)
    ms_of = timer(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    uniq = {key: n for key, n in
            unique_shapes(collect_shapes(args.size, args.n_classes)).items()
            if key[0] == "conv3d_k3"}
    made = {"conv3d_k3": 0, "conv3d_k3_block": 0}
    # the CUDA-core K through its C entry point (bfloat16 on the card)
    simt = getattr(conv3d, "_block_simt", None) \
        if device.type == "cuda" else None

    def a_call(x, w):
        made["conv3d_k3"] += 1
        return conv3d_k3(x, w)

    def k_call(x, w, p):
        made["conv3d_k3_block"] += 1
        return conv3d_k3_block(x, w, p_blk=p)

    print(header(device), flush=True)
    print(f"{len(uniq)} unique k3 shapes (forward, size {list(args.size)}, "
          f"bf16, {device.type}); ms per call; K tensor cores (K), CUDA "
          f"cores (Ks)", flush=True)
    print(f"{'x (B,D,H,W,C)':>24} {'Cin->Cout':>9} {'n':>2} | {'A':>8} | "
          + " | ".join(f"{f'K P={p}':>8}" for p in args.p_blks) + " | "
          + " | ".join(f"{f'Ks P={p}':>8}" for p in args.p_blks)
          + f" | {'F.conv3d':>8} | {'bound':>7}", flush=True)
    rows = []
    with torch.no_grad():
        for (_, xs, ws, _), n in uniq.items():
            x, w = inputs("conv3d_k3", xs, ws, device, gen)
            ref = a_call(x, w)
            digest = hashlib.sha256(
                ref.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            ref = ref.float()
            scale = ref.abs().max().item()
            wk = kernel_operands(x, w, None)[0]
            diffs, simt_diffs = {}, {}
            for p in args.p_blks:
                routes = [("K", k_call(x, w, p), diffs)]
                if simt is not None:
                    routes.append(("K on the CUDA cores", simt(x, wk, p),
                                   simt_diffs))
                for what, got, into in routes:
                    err = (got.float() - ref).abs().max().item()
                    if not err <= TOL["bfloat16"] * scale:
                        raise AssertionError(
                            f"{what} p_blk={p} {xs} -> {ws[-1]}: max|K - A| "
                            f"{err} > {TOL['bfloat16']} * {scale}")
                    into[p] = err
            fns = [(lambda p=p: k_call(x, w, p)) for p in args.p_blks]
            fns += [None if simt is None else (lambda p=p: simt(x, wk, p))
                    for p in args.p_blks]
            fns += [lambda: a_call(x, w), library_call("conv3d_k3", x, w)]
            times = in_turns(fns, ms_of, args.iters)
            npb = len(args.p_blks)
            k_ms = dict(zip(args.p_blks, times[:npb]))
            k_simt_ms = dict(zip(args.p_blks, times[npb:2 * npb]))
            a_ms, lib_ms = times[2 * npb:]
            bms, by = bound(*analyze("conv3d_k3", xs, ws, {}))
            rows.append({"x": list(xs), "cin": ws[-2], "cout": ws[-1],
                         "n": n, "a_ms": a_ms, "k_ms": k_ms,
                         "k_simt_ms": k_simt_ms, "library_ms": lib_ms,
                         "max_abs_diff_vs_a": diffs,
                         "simt_max_abs_diff_vs_a": simt_diffs,
                         "max_abs_a": scale, "a_sha256": digest,
                         "bound_ms": bms, "bound_by": by})
            print(f"{str(xs):>24} {f'{ws[-2]}->{ws[-1]}':>9} {n:>2} | "
                  f"{a_ms:8.3f} | "
                  + " | ".join(_fmt(k_ms[p]) for p in args.p_blks) + " | "
                  + " | ".join(_fmt(k_simt_ms[p]) for p in args.p_blks)
                  + f" | {lib_ms:8.3f} | {bms:7.4f}", flush=True)
            del x, w, wk, ref, fns
    totals = {"a_ms": sum(r["n"] * r["a_ms"] for r in rows),
              "k_ms": {p: sum(r["n"] * r["k_ms"][p] for r in rows)
                       for p in args.p_blks},
              "k_simt_ms": {p: None if simt is None else
                            sum(r["n"] * r["k_simt_ms"][p] for r in rows)
                            for p in args.p_blks},
              "library_ms": sum(r["n"] * r["library_ms"] for r in rows),
              "bound_ms": sum(r["n"] * r["bound_ms"] for r in rows)}
    print(f"{'forward total':>24} {'':>9} {sum(uniq.values()):>2} | "
          f"{totals['a_ms']:8.3f} | "
          + " | ".join(_fmt(totals["k_ms"][p]) for p in args.p_blks) + " | "
          + " | ".join(_fmt(totals["k_simt_ms"][p]) for p in args.p_blks)
          + f" | {totals['library_ms']:8.3f} | {totals['bound_ms']:7.4f}",
          flush=True)
    result = {"tool": "bench_block_conv_torch", "label": args.label,
              "repo": os.path.dirname(os.path.dirname(os.path.abspath(
                  deepatlas_torch.__file__))),
              "device": device.type, "header": header(device),
              "rows": rows, "calls": made, "totals": totals}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
