"""Readings that a cell's limits are set from, on the card:

    python benchmark/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ... [--fault <name>] \\
        [--out <file>]

runs the cell once per seed in one process (set-up, a window of
``--seconds``, the comparison with the reference) and prints, per seed, the
program's readings and, for the control seeds, the control's: the
reference computed in float8 in the program's place.  ``--fault`` plants
one of ``faults.FAULTS`` in the program for every seed.  Not part of a run
of the benchmark.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import faults  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402,F401  (the cache directories run.py fixes)


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    print(harness.nvidia_smi_line(), flush=True)
    out = open(args.out, "a") if args.out else None
    if args.fault:
        faults.FAULTS[args.fault]()
    for seed in args.seeds:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             control=seed in args.control_seeds)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault,
                           "readings": r["readings"] if "readings" in r
                           else {k: c["value"] for k, c
                                 in r["checks"].items()},
                           "control": r.get("control"),
                           "diagnostics": r.get("diagnostics"),
                           "setup_s": r["metrics"]["setup_s"]["value"],
                           "peak_gib": r["metrics"]["peak_mem_gib"]["value"]
                           })
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
