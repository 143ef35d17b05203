"""The per-layer metrics read from the program's own spans, on the CPU at
tiny shapes: a traced run whose profiled stretch leaves units of the window
on both sides of it reports each of them, from spans outside the
stretch."""
from __future__ import annotations

import json
import os
from collections import deque
from types import SimpleNamespace

import pytest

from helpers import ROOT, run_tiny

import harness


def program_span_metrics(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    return [p["name"] for p in m["per_layer"]
            if p["source"] == "program_span" and cell in p["workloads"]]


@pytest.mark.parametrize("cell", ["mb101_seg_nifti", "oai_serve_nifti"])
def test_program_span_metrics_read_outside_the_trace(cell, tmp_path,
                                                     monkeypatch):
    names = program_span_metrics(cell)
    assert names
    # a short profiled stretch in the middle of the window
    monkeypatch.setattr(harness, "TRACE_START_S", 0.5)
    monkeypatch.setattr(harness, "TRACE_LENGTH_S", 0.5)
    r = run_tiny(cell, tmp_path, seconds=3.0, trace=True)
    for name in names:
        assert name in r["metrics"], (name, sorted(r["metrics"]))
        assert r["metrics"][name]["value"] > 0
        assert r["metrics"][name]["unit"] == "ms"


def fake_ctx(units, trace_t):
    from harness import Unit
    window = SimpleNamespace(t0=units[0][0], last=units[-1][1],
                             trace_t=trace_t,
                             units=[Unit("seg", a, b, 1, False)
                                    for a, b in units])
    return SimpleNamespace(window=window)


def test_reader_takes_the_window_outside_the_traced_stretch(monkeypatch):
    """Units 10-11, 11-12 (traced: 11.5-13), 12-13, 13-14; a span of 0.1 s
    in each unit, one more before the window and one in the traced stretch
    that another name carries."""
    from deepatlas_torch.utils import profiling

    from readers import program_spans
    log = deque([("a", 9.0, 9.5), ("a", 10.2, 10.3), ("a", 11.2, 11.6),
                 ("a", 12.2, 12.3), ("b", 13.1, 13.9), ("a", 13.2, 13.3)],
                maxlen=16)
    monkeypatch.setattr(profiling, "_LOG", log)
    ctx = fake_ctx([(10, 11), (11, 12), (12, 13), (13, 14)], (11.5, 13.0))
    # outside the stretch: spans at 10.2 and 13.2, units 10-11 and 13-14
    assert program_spans.read(ctx, ["a"], "unit") == pytest.approx(100.0)
    assert program_spans.read(ctx, ["a"], "span") == pytest.approx(100.0)
    assert program_spans.read(ctx, ["a", "b"], "unit") == \
        pytest.approx(500.0)
    assert program_spans.read(ctx, ["c"], "unit") is None
    # untraced: every unit and span of the window
    ctx = fake_ctx([(10, 11), (11, 12), (12, 13), (13, 14)], ())
    assert program_spans.read(ctx, ["a"], "span") == pytest.approx(
        (100 + 400 + 100 + 100) / 4)
    # a log that dropped spans of the window reads nothing
    monkeypatch.setattr(profiling, "_LOG", deque(list(log)[-3:], maxlen=3))
    assert program_spans.read(ctx, ["a"], "unit") is None


def test_reader_reads_nothing_from_a_program_without_a_span_log(
        monkeypatch):
    from deepatlas_torch.utils import profiling

    from readers import program_spans
    monkeypatch.delattr(profiling, "spans_between")
    ctx = fake_ctx([(10, 11)], ())
    assert program_spans.read(ctx, ["a"], "unit") is None
