#!/usr/bin/env python
"""One benchmark cell run as ``benchmark/run.py`` runs it, plus what the
profiler costs each ``program_span`` metric: the same metric read inside
the profiled stretch (``Window.trace_t``) as the benchmark reads it
outside, and each program span's count and mean ms inside, outside and
across the stretch's edge.

    python tools/span_profiler_cost_torch.py --workload <name> \\
        --seed <n> --seconds <s> --trace 1

from the root of the repo.  Standard output is ``run.py``'s; the readings
are one line of standard error, ``SPANS {json}``, after the result.  With
``--trace 0`` there is no stretch and the inside readings are null.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path[:0] = [BENCH, ROOT]
# the build and kernel caches where benchmark/run.py puts them
_BUILD = os.path.join(ROOT, "deepatlas_torch", "kernels", "_build")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_BUILD, "torch_extensions")
os.environ["USE_FLAX"] = "0"

import harness  # noqa: E402

_readings = {"inside": {}, "outside": {}}
_benchmark_value = harness.reader_value


def _inside(ctx, spans, per):
    """``readers/program_spans.read``'s number over the stretch's spans
    and units instead of those outside it."""
    from deepatlas_torch.utils.profiling import spans_between
    w = ctx.window
    events = spans_between(w.t0, w.last)
    if events is None or not w.trace_t:
        return None
    a, b = w.trace_t
    ms = [1e3 * (e - s) for n, s, e in events
          if n in spans and s >= a and e <= b]
    if not ms:
        return None
    if per == "span":
        return sum(ms) / len(ms)
    units = sum(u.traced for u in w.units)
    return sum(ms) / units if units else None


def _per_span(ctx):
    """Each span's count and mean ms inside, outside and across the
    stretch, over the window."""
    from deepatlas_torch.utils.profiling import spans_between
    w = ctx.window
    a, b = w.trace_t or (0.0, 0.0)
    sides = {}
    for n, s, e in spans_between(w.t0, w.last) or []:
        side = "in" if s >= a and e <= b else (
            "out" if e <= a or s >= b else "edge")
        d = sides.setdefault(n, {}).setdefault(side, [0, 0.0])
        d[0] += 1
        d[1] += 1e3 * (e - s)
    return {
        "units": len(w.units), "traced_units": sum(u.traced for u in w.units),
        "window_s": w.last - w.t0,
        "trace_t": [a - w.t0, b - w.t0] if w.trace_t else None,
        "ms_per_span": {n: {k: [c, t / c] for k, (c, t) in v.items()}
                        for n, v in sides.items()}}


def reader_value(ctx, metric):
    value = _benchmark_value(ctx, metric)
    spec = harness.load_json(harness.HERE, "metrics", metric + ".json")
    if spec["reader"] == "program_spans":
        _readings["inside"][metric] = _inside(ctx, **spec["params"])
        _readings["outside"][metric] = value
        if "spans" not in _readings:
            _readings["spans"] = _per_span(ctx)
    return value


harness.reader_value = reader_value

if __name__ == "__main__":
    code = harness.main()
    print("SPANS " + json.dumps(_readings), file=sys.stderr, flush=True)
    harness.exit_now(code)
