#!/usr/bin/env python
"""What one span of ``deepatlas_torch.utils.annotate`` costs on this host:
the profiler off; the profiler on (CPU, and CUDA where there is a card) on
the main thread, which opens a ``record_function`` marker; the profiler on
in another thread, which logs the span and opens no marker.

Each number is the best of 5 loops of empty spans, less the same loop
without the span, in ns a span.  Prints one JSON object with the card's
name and power limit where ``nvidia-smi`` answers.

  python tools/span_cost_torch.py [--spans 200000]
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def per_span(n):
    from deepatlas_torch.utils import annotate
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with annotate("cost.span"):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            pass
        t2 = time.perf_counter()
        best = min(best, ((t1 - t0) - (t2 - t1)) / n)
    return best * 1e9


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=200000,
                    help="spans a loop with the profiler off (a tenth on)")
    args = ap.parse_args(argv)

    import torch
    out = {}
    try:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["card"] = None
    out["off_ns"] = per_span(args.spans)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        out["on_main_thread_ns"] = per_span(args.spans // 10)
        other = {}
        t = threading.Thread(
            target=lambda: other.update(ns=per_span(args.spans // 10)))
        t.start()
        t.join()
        out["on_other_thread_ns"] = other["ns"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
