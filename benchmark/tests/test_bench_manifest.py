"""``BENCHMARK.json`` against the benchmark's contract, and its files."""
from __future__ import annotations

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per|encoders|"
                   r"decoders|reg_enc|reg_dec|n_classes|tile")


@pytest.fixture(scope="module")
def m():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def test_keys_and_command(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32
    assert m["command"][1] == "benchmark/run.py"
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines(m):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names), names
    metric_names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(x["layer"]) <= 200 and "\n" not in x["layer"]
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configs(m):
    used = {w["config"] for w in m["workloads"]}
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        cfg = load(*c["file"].split("/")[1:])
        assert c["source"] == cfg["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)


def test_cells(m):
    cells = m["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        job = load("traffic", w["traffic"] + ".json")["job"]
        assert os.path.exists(os.path.join(BENCH, "jobs", job + ".py"))


def reports(m, cell):
    return {e["name"] for e in m["end_to_end"]
            if cell in e.get("workloads", [cell])}


def test_end_to_end(m):
    cells = {w["name"] for w in m["workloads"]}
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        assert set(e.get("workloads", cells)) <= cells
    for cell in cells:
        got = reports(m, cell)
        assert "setup_s" in got and len(got) >= 2


def test_per_layer(m):
    cells = {w["name"] for w in m["workloads"]}
    for p in m["per_layer"]:
        assert p["workloads"], p["name"]
        for cell in p["workloads"]:
            assert cell in cells
            assert p["moves"] in reports(m, cell), (p["name"], cell)
        spec = load("metrics", p["name"] + ".json")
        assert set(spec) == {"reader", "params"}
        assert os.path.exists(os.path.join(BENCH, "readers",
                                           spec["reader"] + ".py"))
        if "roofline" in p["name"]:
            assert p["name"].endswith("_roofline") and p["unit"] == "%"
    for cell in cells:
        assert any(cell in p["workloads"] for p in m["per_layer"])


def test_layers_in_perf_md(m):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for layer in {p["layer"] for p in m["per_layer"]}:
        assert f"| {layer} |" in perf, layer


def test_check_budget(m):
    """A full check of 24 cells (2 + 14 x 24 runs, each allowed
    ``run_seconds`` + 60 s, 180 s a cell to compile, 1200 s spare) fits in
    43200 s."""
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= m["run_seconds"] <= 51


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(BENCH):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            assert PATH.match(os.path.relpath(os.path.join(dirpath, f),
                                              ROOT)), f
