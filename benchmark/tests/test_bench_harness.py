"""The harness end to end on the CPU at tiny shapes: the result's keys, the
failure without a card, the import check and the data-driven layout."""
from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys


from helpers import BENCH, ROOT, run_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "deepatlas_tpu"}


def test_result_keys(tmp_path):
    r = run_tiny("mb101_seg_preload", tmp_path)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert set(r["metrics"]) == {"train_samples_per_s", "peak_mem_gib",
                                 "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_traced_serving_line(tmp_path):
    r = run_tiny("oai_serve_nifti", tmp_path, trace=True)
    assert {"data.wait_share.serve", "tiling.host_ms_per_volume",
            "serve.volume_p90_s", "mfu.serve"} <= set(r["metrics"])
    assert list(r)[-1] == "checks"


def test_no_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mb101_seg_preload", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "oai_serve_nifti", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", "") == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def python_files(top):
    for dirpath, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_imports_by_whole_top_level_name():
    """Nothing the benchmark runs imports JAX or the JAX package, and the
    reference imports nothing of the program (whole top-level names: the
    port's name begins with the JAX package's)."""
    for path in python_files(BENCH):
        tops = set(imported_tops(path))
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert "deepatlas_torch" not in tops, path


def test_run_leaves_no_jax_loaded(tmp_path):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from helpers import run_tiny\n"
            "import pathlib, harness\n"
            "run_tiny('mb101_joint_preload', pathlib.Path(%r))\n"
            "print(harness.forbidden_modules())\n"
            % (os.path.join(BENCH, "tests"), BENCH, str(tmp_path)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def digest(top):
    out = {}
    for dirpath, _, files in os.walk(top):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A later change adds a cell (a traffic mix) and a per-layer metric (a
    data file and its reader) as new files and manifest entries; the
    harness lists and runs them with no file of the benchmark edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    b = tmp_path / "benchmark"
    (b / "traffic" / "seg_preload_dummy.json").write_text(json.dumps(
        {"job": "seg", "preload": True, "num_workers": None}))
    (b / "readers" / "unit_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.units))\n")
    (b / "metrics" / "experiment.units.json").write_text(json.dumps(
        {"reader": "unit_count", "params": {}}))
    m["workloads"].append({"name": "mb101_seg_dummy",
                           "config": "deepatlas_mb101",
                           "traffic": "seg_preload_dummy", "chips": 1,
                           "why": "a test cell"})
    m["end_to_end"][0]["workloads"].append("mb101_seg_dummy")
    m["per_layer"].append({"name": "experiment.units", "unit": "units",
                           "better": "higher", "source": "host_clock",
                           "layer": "experiment",
                           "moves": "train_samples_per_s",
                           "workloads": ["mb101_seg_dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import sys, pathlib; sys.path[:0] = [%r, %r, %r]\n"
            "import torch, harness, helpers\n"
            "spec = harness.cell_spec('mb101_seg_dummy')\n"
            "print([p['name'] for p in spec['per_layer']])\n"
            "r = harness.run_cell('mb101_seg_dummy', 5, 1.0, True, "
            "device='cpu', workdir=%r, overrides=helpers.TINY_MB)\n"
            "print(r['metrics']['experiment.units']['value'])\n"
            % (str(b), str(b / "tests"), ROOT, str(tmp_path / "w")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert any(ln.startswith("[") and "experiment.units" in ln
               for ln in lines)
    assert float(lines[-1]) >= 1
    after = digest(b)
    assert {k: v for k, v in after.items() if k in before} == before
