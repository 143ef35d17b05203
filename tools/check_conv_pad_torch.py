#!/usr/bin/env python3
"""Kernels A and D against another checkout at depth padding 1, and at
depth padding 0 against their plain versions and the full-volume conv.

On one CUDA card: ``conv3d_k3``, ``conv3d_k3_input_grad`` and
``conv3d_k3_wgrad`` at stride 1 and 2, in float32 and bfloat16, on seeded
inputs at narrow, odd and wide shapes.
- ``--repo DIR`` (a checkout of an earlier commit, e.g. ``git archive
  <commit> | tar -x -C tmp/parent``): the three functions at depth padding
  1 in a subprocess on that checkout's package, and here; every output
  must be equal bit for bit.
- ``pad_d=0``: each function against its plain version (relative 1e-4 in
  float32, 1e-2 in bfloat16, 1e-4 for ``dW``); ``dW`` twice, bit for bit;
  the forward equal to the padded conv's slab and the stride-1 ``dx`` to
  the padded conv's of the gradient with a zero plane on each side, bit
  for bit in float32 (the stride-2 forward from its second plane: the
  padded conv's first output reads its zero plane).
One JSON line per case, then ``{"ok": ...}``; exits 1 on a failure.

  python tools/check_conv_pad_torch.py --repo tmp/parent
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD1_CASES = [(1, 10, 12, 20, 16, 32), (2, 9, 7, 33, 3, 8),
              (1, 18, 16, 24, 64, 64), (1, 12, 9, 11, 8, 3)]
PAD0_CASES = [(1, 10, 12, 20, 16, 32), (2, 8, 7, 33, 3, 8),
              (1, 18, 16, 24, 64, 64), (1, 12, 9, 11, 8, 3),
              (1, 42, 25, 21, 64, 64), (1, 22, 100, 84, 16, 32)]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def pad1_outputs(path):
    """The three functions at depth padding 1 on seeded inputs, saved to
    ``path`` (run in either checkout)."""
    import torch

    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_input_grad,
                                         conv3d_k3_wgrad)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for (b, d, h, w, ci, co) in PAD1_CASES:
            for s in (1, 2):
                x = (torch.rand((b, d, h, w, ci), generator=gen,
                                device="cuda") * 2 - 1).to(dt)
                wt = torch.randn((3, 3, 3, ci, co), generator=gen,
                                 device="cuda") / np.sqrt(27 * ci)
                y = conv3d_k3(x, wt, stride=s)
                g = (torch.rand(y.shape, generator=gen, device="cuda") * 2
                     - 1).to(dt)
                key = f"{dt}_{b}_{d}_{h}_{w}_{ci}_{co}_{s}"
                out[key + "_fwd"] = y.float().cpu()
                out[key + "_dx"] = conv3d_k3_input_grad(
                    g, wt, (d, h, w), s).float().cpu()
                out[key + "_dw"] = conv3d_k3_wgrad(x, g, s).cpu()
    torch.save(out, path)


def pad0_cases():
    import torch
    import torch.nn.functional as F

    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain,
                                         conv3d_k3_plain, conv3d_k3_wgrad,
                                         conv3d_k3_wgrad_plain)

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / max(
            b.float().abs().max().item(), 1e-30)

    gen = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for (b, d, h, w, ci, co) in PAD0_CASES:
            for s in (1, 2):
                x = (torch.rand((b, d, h, w, ci), generator=gen,
                                device="cuda") * 2 - 1).to(dt)
                wt = torch.randn((3, 3, 3, ci, co), generator=gen,
                                 device="cuda") / np.sqrt(27 * ci)
                y = conv3d_k3(x, wt, stride=s, pad_d=0)
                if s == 1:
                    slab, full = y, conv3d_k3(x, wt)[:, 1:-1]
                else:
                    slab = y[:, 1:]
                    full = conv3d_k3(x[:, 1:].contiguous(), wt,
                                     stride=2)[:, 1:y.shape[1]]
                g = (torch.rand(y.shape, generator=gen, device="cuda") * 2
                     - 1).to(dt)
                dx = conv3d_k3_input_grad(g, wt, (d, h, w), s, pad_d=0)
                dw = conv3d_k3_wgrad(x, g, s, pad_d=0)
                r = {"dtype": dname, "shape": [b, d, h, w, ci, co],
                     "stride": s,
                     "fwd": rel(y, conv3d_k3_plain(x, wt, stride=s,
                                                   pad_d=0)),
                     "fwd_slab_equal": bool(torch.equal(slab, full)),
                     "dx": rel(dx, conv3d_k3_input_grad_plain(
                         g, wt, (d, h, w), s, pad_d=0)),
                     "dw": rel(dw, conv3d_k3_wgrad_plain(x, g, s, 0)),
                     "dw_repeat": bool(torch.equal(
                         dw, conv3d_k3_wgrad(x, g, s, pad_d=0)))}
                if s == 1:
                    r["dx_slab_equal"] = bool(torch.equal(
                        dx, conv3d_k3_input_grad(
                            F.pad(g, (0, 0, 0, 0, 0, 0, 1, 1)), wt,
                            (d, h, w), 1)))
                good = r["fwd"] <= TOL[dname] and r["dx"] <= TOL[dname] \
                    and r["dw"] <= 1e-4 and r["dw_repeat"]
                if dname == "float32":
                    good = good and r["fwd_slab_equal"] \
                        and r.get("dx_slab_equal", True)
                r["ok"] = good
                ok = ok and good
                print(json.dumps(r), flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=None,
                    help="another checkout: depth padding 1 against it, "
                         "bit for bit")
    ap.add_argument("--save-pad1", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("check_conv_pad_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.save_pad1:
        # the subprocess on the other checkout: its package, its kernels
        pad1_outputs(args.save_pad1)
        return 0
    sys.path.insert(0, REPO)
    from deepatlas_torch.kernels import build
    build.build()
    ok = True
    if args.repo:
        with tempfile.TemporaryDirectory() as tmp:
            theirs = os.path.join(tmp, "theirs.pt")
            mine = os.path.join(tmp, "mine.pt")
            repo = os.path.abspath(args.repo)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--save-pad1", theirs], check=True, cwd=repo,
                           env=dict(os.environ, PYTHONPATH=repo))
            pad1_outputs(mine)
            a, b = torch.load(theirs), torch.load(mine)
            differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
        print(json.dumps({"pad1_against": args.repo, "outputs": len(a),
                          "differ": differ}), flush=True)
        ok = not differ
    ok = pad0_cases() and ok
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
