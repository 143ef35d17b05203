"""The harness: runs one cell of ``BENCHMARK.json`` once and prints its line.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); the mix names its job (``jobs/<job>.py``),
which builds the system under test from the seed, runs its entry in the
measured window and checks what that produced against the plain reference.
A per-layer metric is ``metrics/<name>.json``, naming its reader
(``readers/<reader>.py``) and the reader's parameters.  Adding a cell, a mix
or a metric adds files; no file here changes.

The window: every unit of work (a training step, a served volume) ends at a
device synchronisation and reports itself at ``Window.boundary``; the
window closes at the first boundary past ``--seconds``.  With ``--trace 1``
``torch.profiler`` records a steady stretch of whole units inside it.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepatlas_tpu")
# where the traced stretch starts and how long it lasts, in seconds
TRACE_START_S = 3.0
TRACE_LENGTH_S = 5.0


class WindowClosed(Exception):
    """Raised at the first unit boundary past the window's end."""


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux ``/proc``);
    the harness's own import time where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_spec(name: str, entry: Optional[dict] = None) -> dict:
    """The cell's manifest entry with its configuration and traffic mix
    (``entry`` stands for the manifest entry of a cell the manifest does
    not hold, as a test runs one)."""
    m = manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if entry is None and name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = entry or cells[name]
    return {"cell": w, "config": load_json(HERE, "configs",
                                           w["config"] + ".json"),
            "traffic": load_json(HERE, "traffic", w["traffic"] + ".json"),
            "end_to_end": [e for e in m["end_to_end"]
                           if name in e.get("workloads", [name])],
            "per_layer": per_layer_of(m, name)}


def per_layer_of(m: dict, name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric it reports."""
    e2e = {e["name"] for e in m["end_to_end"]
           if name in e.get("workloads", [name])}
    return [p for p in m["per_layer"]
            if name in p.get("workloads", [])
            or ("workloads" not in p and p["moves"] in e2e)]


# ------------------------------------------------------------------ spans
class Spans:
    """The benchmark's own spans around calls into the program's layers:
    host seconds summed by name, and, while tracing, a
    ``torch.profiler.record_function`` so that the trace carries them."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.tracing:
            import torch
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0


@dataclass
class Unit:
    kind: str
    t0: float
    t1: float
    samples: int
    traced: bool


@dataclass
class Window:
    """The measured window and its unit boundaries."""
    seconds: float
    trace: bool
    device: object
    spans: Spans
    trace_path: str = ""
    units: List[Unit] = field(default_factory=list)
    t0: float = 0.0
    last: float = 0.0
    profiler: object = None
    trace_t: tuple = ()

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def start(self):
        self.sync()
        self.t0 = self.last = time.perf_counter()

    def boundary(self, kind: str, samples: int) -> None:
        """A unit of ``kind`` with ``samples`` samples has completed.  Raises
        ``WindowClosed`` once the window's time is up."""
        self.sync()
        t = time.perf_counter()
        traced = self.profiler is not None and not self.trace_t
        self.units.append(Unit(kind, self.last, t, samples, traced))
        self.last = t
        if self.trace:
            self._profile(t)
        if t - self.t0 >= self.seconds:
            self.stop_profiler(t)
            raise WindowClosed()

    def _profile(self, t):
        if self.profiler is None and t - self.t0 >= min(
                TRACE_START_S, self.seconds / 4):
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.start()
            self.spans.tracing = True
            self._prof_t0 = time.perf_counter()
        elif self.profiler is not None and not self.trace_t \
                and t - self._prof_t0 >= TRACE_LENGTH_S:
            self.stop_profiler(t)

    def stop_profiler(self, t):
        if self.profiler is not None and not self.trace_t:
            self.profiler.stop()
            self.spans.tracing = False
            self.trace_t = (self._prof_t0, t)

    def export_trace(self) -> None:
        """Write the stopped profiler's trace, after the window."""
        if self.profiler is not None and self.trace_t:
            self.profiler.export_chrome_trace(self.trace_path)
            self.profiler = None

    @property
    def elapsed(self) -> float:
        """From the window's start to the end of its last unit."""
        return (self.units[-1].t1 - self.t0) if self.units else 0.0

    def traced_units(self) -> List[Unit]:
        return [u for u in self.units if u.traced]


# ------------------------------------------------------------------ trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Device operations and the benchmark's spans of the traced stretch,
    in seconds on the trace's clock."""
    ops: List[tuple]            # (name, start, duration, category)
    spans: List[tuple]          # (name, start, end)
    window_s: float

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, -1e30
        for _, s, d, _ in sorted(self.ops, key=lambda o: o[1]):
            if s + d > end:
                busy += s + d - max(s, end)
                end = s + d
        return busy

    def kernel_seconds(self, match=None) -> float:
        """Device seconds of the kernels whose name ``match`` accepts (all
        kernels without one)."""
        return sum(d for n, _, d, cat in self.ops
                   if cat == "kernel" and (match is None or match(n)))

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for n, _, d, _ in self.ops:
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: Dict[str, float] = {}
        end = None
        for _, s, d, _ in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                gaps[self.span_at((s + end) / 2)] = \
                    gaps.get(self.span_at((s + end) / 2), 0.0) + s - end
            end = s + d if end is None else max(end, s + d)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def span_at(self, t: float) -> str:
        """The innermost benchmark span open at ``t``."""
        best, best_len = "outside any span", float("inf")
        for n, s, e in self.spans:
            if s <= t <= e and e - s < best_len:
                best, best_len = n, e - s
        return best


def short_name(name: str) -> str:
    """A kernel's qualified function name without ``void``, anonymous
    namespaces, template and argument lists."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    return s.split("(")[0].split("<")[0].strip() or name[:64]


def read_trace(path: str, window_s: float) -> Optional[Trace]:
    """The device operations and the host annotations (the benchmark's
    spans and the program's own) of an exported Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((e["name"], e["ts"] * 1e-6, e.get("dur", 0) * 1e-6,
                        cat))
        elif cat == "user_annotation":
            spans.append((e["name"], e["ts"] * 1e-6,
                          (e["ts"] + e.get("dur", 0)) * 1e-6))
    if not ops:
        return None
    return Trace(ops, spans, window_s)


# ------------------------------------------------------------- the context
@dataclass
class Context:
    """What a job gets: the run's seed and sizes, where to write, the
    window and the spans; what the readers get besides: the job's counters
    and the trace."""
    name: str
    seed: int
    config: dict
    traffic: dict
    device: object
    workdir: str
    window: Window
    spans: Spans
    counters: dict = field(default_factory=dict)
    trace: Optional[Trace] = None
    setup_s: float = 0.0


def reader_value(ctx: Context, metric: str) -> Optional[float]:
    spec = load_json(HERE, "metrics", metric + ".json")
    mod = importlib.import_module("readers." + spec["reader"])
    return mod.read(ctx, **spec.get("params", {}))


def limits_of(name: str) -> dict:
    """The cell's limits, ``limits/<cell>.json`` (none before they are
    set: every number then fails)."""
    path = os.path.join(HERE, "limits", name + ".json")
    if not os.path.exists(path):
        return {}
    return {k: v["limit"] for k, v in load_json(path).items()}


def checks_of(name: str, readings: dict) -> dict:
    """The numbers compared, each beside its limit: those the cell's limits
    name (every reading, each failing, while it has none)."""
    limits = limits_of(name)
    if not limits:
        return {k: {"value": v, "limit": -1.0} for k, v in readings.items()}
    return {k: {"value": readings.get(k, float("inf")), "limit": lim}
            for k, lim in limits.items()}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------ running
def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, workdir: Optional[str] = None,
             overrides: Optional[dict] = None, start: Optional[float] = None,
             control: bool = False, entry: Optional[dict] = None) -> dict:
    """Run the cell once and return its result (the printed line's dict).
    ``overrides`` replaces keys of the configuration and the traffic mix
    (the CPU tests' small shapes).  ``control`` adds the control's
    readings (the reference in a lower precision in the program's place)
    under ``control``: what the limits are set from, never part of a run
    of the benchmark."""
    import torch

    from reference.precision import exact_float32

    start = process_start() if start is None else start
    spec = cell_spec(name, entry)
    config = dict(spec["config"], **(overrides or {}).get("config", {}))
    traffic = dict(spec["traffic"], **(overrides or {}).get("traffic", {}))
    device = torch.device("cuda" if device is None else device)
    workdir = workdir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "deepatlas_bench",
        f"{name}.{seed}")
    os.makedirs(workdir, exist_ok=True)
    spans = Spans()
    window = Window(seconds, trace, device, spans,
                    trace_path=os.path.join(workdir, "trace.json"))
    ctx = Context(name, seed, config, traffic, device, workdir, window,
                  spans)
    job = importlib.import_module("jobs." + traffic["job"]).Job(ctx)
    try:
        job.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        ctx.setup_s = time.time() - start
        window.start()
        job.run_window()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        window.export_trace()
        job.close_window()
        ctx.counters["elapsed_s"] = window.elapsed
        metrics = {}
        e2e = job.end_to_end()
        e2e["setup_s"] = ctx.setup_s
        e2e["peak_mem_gib"] = peak / 2 ** 30
        units = {e["name"]: e["unit"] for e in spec["end_to_end"]}
        per_layer = {p["name"]: p["unit"] for p in spec["per_layer"]}
        if trace:
            ctx.trace = read_trace(
                window.trace_path, window.trace_t[1] - window.trace_t[0]) \
                if window.trace_t else None
            for metric, unit in per_layer.items():
                v = reader_value(ctx, metric)
                if v is not None:
                    metrics[metric] = {"value": v, "unit": unit}
        else:
            for metric, unit in units.items():
                metrics[metric] = {"value": e2e[metric], "unit": unit}
        with exact_float32():
            readings = job.readings()
            if control:
                control_readings = job.control_readings()
        checks = checks_of(name, readings)
    finally:
        job.cleanup()
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": sum(u.samples for u in window.units),
           "failed": 0, "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = ctx.trace.breakdown()
    if control:
        out["readings"] = readings
        out["control"] = control_readings
        out["diagnostics"] = getattr(job, "diagnostics", None)
    out["checks"] = checks
    return out


def nvidia_smi_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not readable: {e}"


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    start = process_start()
    import torch
    need = cell_spec(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA device(s), this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(nvidia_smi_line(), flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), start=start)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the run loaded {bad}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    sys.stderr.flush()
    return 0


def exit_now(code: int) -> None:
    """End the process without the interpreter's teardown: after a traced
    window the profiler's CUDA callbacks can crash it at exit, after the
    result is out.  Every thread the run started has been joined."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
