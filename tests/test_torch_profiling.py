"""``deepatlas_torch.utils.profiling``'s spans: the log of every span's
start and end on ``time.perf_counter``, from any thread; a
``torch.profiler`` marker only while the profiler records and only on the
main thread (not for the loader's ``data.decode``); the bounded log
dropping its oldest spans, and ``spans_between`` refusing an interval the
drop reaches into."""
import glob
import json
import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from deepatlas_torch.data import DataLoader
from deepatlas_torch.utils import annotate, profiling, spans_between, trace


def test_log_records_name_start_and_end_from_several_threads():
    """More threads than cores, switching often: no span is lost, and each
    thread's spans are logged in the order they ran."""
    n_threads, n_spans = (os.cpu_count() or 1) + 2, 200
    t0 = time.perf_counter()
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait()
        for _ in range(n_spans):
            with annotate(f"test.thread{k}"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    with annotate("test.outer"):
        with annotate("test.inner"):
            time.sleep(0.01)
    t1 = time.perf_counter()
    spans = spans_between(t0, t1)
    for k in range(n_threads):
        mine = [s for s in spans if s[0] == f"test.thread{k}"]
        assert len(mine) == n_spans
        assert all(a[2] <= b[1] for a, b in zip(mine, mine[1:]))
    assert [n for n, _, _ in spans[-2:]] == ["test.inner", "test.outer"]
    (_, s_in, e_in), (_, s_out, e_out) = spans[-2:]
    assert t0 <= s_out <= s_in < e_in <= e_out <= t1
    assert e_in - s_in >= 0.01
    assert all(t0 <= s <= e <= t1 for _, s, e in spans)


def test_no_marker_while_the_profiler_is_off(monkeypatch):
    built = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        built.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with annotate("test.off"):
        torch.ones(4).sum()
    assert built == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("test.on"):
            torch.ones(4).sum()
        other = threading.Thread(target=_span_on_this_thread,
                                 args=("test.other_thread",))
        other.start()
        other.join(timeout=60)
    assert not other.is_alive()
    assert built == ["test.on"]
    assert "test.other_thread" in [n for n, _, _ in profiling._LOG]


def _span_on_this_thread(name):
    with annotate(name):
        torch.ones(4).sum()


class _Volumes:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return {"image": np.full((4, 4, 4), float(i), np.float32)}


def test_trace_holds_the_calling_threads_spans_nested(tmp_path):
    log_dir = str(tmp_path / "trace")
    loader = DataLoader(_Volumes(), batch_size=2, prefetch=2, num_workers=2)
    with trace(log_dir):
        with annotate("experiment.step"):
            with annotate("step.forward"):
                torch.ones(64).sum()
            for _ in loader:
                pass
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    by_name = {e["name"]: e for e in events}
    assert "data.decode" not in by_name
    outer, inner = by_name["experiment.step"], by_name["step.forward"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["tid"] == inner["tid"]


def test_bounded_log_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "_LOG", deque(maxlen=4))
    t0 = time.perf_counter()
    for i in range(3):
        with annotate(f"test.{i}"):
            pass
    t1 = time.perf_counter()
    assert [n for n, _, _ in spans_between(t0, t1)] == \
        ["test.0", "test.1", "test.2"]
    for i in range(3, 6):
        with annotate(f"test.{i}"):
            pass
    t2 = time.perf_counter()
    # test.0 and test.1 dropped out: an interval from t0 is incomplete
    assert [n for n, _, _ in profiling._LOG] == \
        ["test.2", "test.3", "test.4", "test.5"]
    assert spans_between(t0, t2) is None
    # from t1 on the log holds every span: the dropped ones ended before
    assert [n for n, _, _ in spans_between(t1, t2)] == \
        ["test.3", "test.4", "test.5"]
