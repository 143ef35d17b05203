"""Microbench: kernel K (``conv3d_k3_block``, ``p_blk`` output planes per
block) against kernel A (``conv3d_k3``) on every k3 conv shape of
UNet_light's forward.

Twin of ``tools/bench_block_conv.py``, which times the JAX package's
multi-plane Pallas kernel against its one-plane kernel on a TPU.  For every
unique k3 shape that ``collect_shapes`` (``tools/bench_packed_conv_torch.py``)
finds, it times in bfloat16, on random inputs from ``--seed``, kernel A,
kernel K at each ``--p-blks`` value, and cuDNN's ``F.conv3d`` of the same
conv (a yardstick only: the port never calls it), each with CUDA events over
``--iters`` launches after one warm-up.  K is held against A at every
``p_blk`` (both round one float32 sum to bf16: within 1e-2 of A's largest
output, as in ``chip_smoke.py``); a mismatch or any error fails the run.
``--device cpu`` runs the same calls on the CPU (the plain versions and the
CPU's ``F.conv3d``, host clock) for the tests: its times are no device
numbers.

  python tools/bench_block_conv_torch.py [--iters 10] [--p-blks 2 4 8]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_packed_conv_torch import (analyze, bound, collect_shapes, header,
                                     inputs, timer, unique_shapes)
from chip_smoke import TOL, library_call


def main(argv=None):
    """Print the table; return ``{"device", "rows", "calls", "totals"}``:
    per shape A's, K's (per ``p_blk``) and the library's ms, K's largest
    difference from A, the bound; ``calls`` counts the wrapper calls made
    here per kernel (each one launch on the card); ``totals`` weights each
    shape by its calls per forward."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--size", type=int, nargs=3, default=[168, 200, 168])
    ap.add_argument("--n-classes", type=int, default=32)
    ap.add_argument("--p-blks", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from deepatlas_torch import resolve_device
    from deepatlas_torch.kernels import conv3d_k3, conv3d_k3_block

    device = resolve_device(args.device)
    ms_of = timer(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    uniq = {key: n for key, n in
            unique_shapes(collect_shapes(args.size, args.n_classes)).items()
            if key[0] == "conv3d_k3"}
    made = {"conv3d_k3": 0, "conv3d_k3_block": 0}

    def a_call(x, w):
        made["conv3d_k3"] += 1
        return conv3d_k3(x, w)

    def k_call(x, w, p):
        made["conv3d_k3_block"] += 1
        return conv3d_k3_block(x, w, p_blk=p)

    print(header(device), flush=True)
    print(f"{len(uniq)} unique k3 shapes (forward, size {list(args.size)}, "
          f"bf16, {device.type}); ms per call", flush=True)
    print(f"{'x (B,D,H,W,C)':>24} {'Cin->Cout':>9} {'n':>2} | {'A':>8} | "
          + " | ".join(f"{f'K P={p}':>8}" for p in args.p_blks)
          + f" | {'F.conv3d':>8} | {'bound':>7}", flush=True)
    rows = []
    with torch.no_grad():
        for (_, xs, ws, _), n in uniq.items():
            x, w = inputs("conv3d_k3", xs, ws, device, gen)
            ref = a_call(x, w).float()
            scale = ref.abs().max().item()
            diffs, k_ms = {}, {}
            for p in args.p_blks:
                err = (k_call(x, w, p).float() - ref).abs().max().item()
                if not err <= TOL["bfloat16"] * scale:
                    raise AssertionError(
                        f"conv3d_k3_block p_blk={p} {xs} -> {ws[-1]}: "
                        f"max|K - A| {err} > {TOL['bfloat16']} * {scale}")
                diffs[p] = err
                k_ms[p] = ms_of(lambda p=p: k_call(x, w, p), args.iters)
            a_ms = ms_of(lambda: a_call(x, w), args.iters)
            lib_ms = ms_of(library_call("conv3d_k3", x, w), args.iters)
            bms, by = bound(*analyze("conv3d_k3", xs, ws, {}))
            rows.append({"x": list(xs), "cin": ws[-2], "cout": ws[-1],
                         "n": n, "a_ms": a_ms, "k_ms": k_ms,
                         "library_ms": lib_ms, "max_abs_diff_vs_a": diffs,
                         "max_abs_a": scale, "bound_ms": bms,
                         "bound_by": by})
            print(f"{str(xs):>24} {f'{ws[-2]}->{ws[-1]}':>9} {n:>2} | "
                  f"{a_ms:8.3f} | "
                  + " | ".join(f"{k_ms[p]:8.3f}" for p in args.p_blks)
                  + f" | {lib_ms:8.3f} | {bms:7.4f}", flush=True)
            del x, w, ref
    totals = {"a_ms": sum(r["n"] * r["a_ms"] for r in rows),
              "k_ms": {p: sum(r["n"] * r["k_ms"][p] for r in rows)
                       for p in args.p_blks},
              "library_ms": sum(r["n"] * r["library_ms"] for r in rows),
              "bound_ms": sum(r["n"] * r["bound_ms"] for r in rows)}
    print(f"{'forward total':>24} {'':>9} {sum(uniq.values()):>2} | "
          f"{totals['a_ms']:8.3f} | "
          + " | ".join(f"{totals['k_ms'][p]:8.3f}" for p in args.p_blks)
          + f" | {totals['library_ms']:8.3f} | {totals['bound_ms']:7.4f}",
          flush=True)
    return {"device": device.type, "rows": rows, "calls": made,
            "totals": totals}


if __name__ == "__main__":
    main()
