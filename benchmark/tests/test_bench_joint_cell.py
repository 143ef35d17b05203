"""The manifest's joint cell, ``mb101_joint_preload``, run through the
harness on the CPU at tiny shapes: its configuration
(``deepatlas_joint_mb101``), mix, job and limits as the manifest names
them, the joint experiment's spans read by the cell's per-layer metrics,
and the comparison with the plain reference finding it correct.

The limits were set on the card at the cell's size.  At these shapes over
ten seeds the numbers read within them (``grad_median_gap`` 0.0071-0.019,
``reg_grad_median_gap`` 0.0015-0.15, ``update_gap`` 0.061-0.20); the test
runs the benchmark tests' own seed (``helpers.run_tiny``'s).
"""
from __future__ import annotations

import torch

from helpers import TINY_MB

import harness


def test_joint_cell_runs_from_the_manifest_and_is_correct(tmp_path):
    spec = harness.cell_spec("mb101_joint_preload")
    assert spec["cell"]["config"] == "deepatlas_joint_mb101"
    assert [e["name"] for e in spec["end_to_end"]] == [
        "train_samples_per_s", "peak_mem_gib", "setup_s"]
    torch.set_num_threads(4)
    r = harness.run_cell("mb101_joint_preload", 2 ** 31 + 99, 1.0, True,
                         device="cpu", workdir=str(tmp_path / "work"),
                         overrides=TINY_MB)
    assert set(r["checks"]) == set(harness.limits_of("mb101_joint_preload"))
    assert r["correct"], r["checks"]
    assert {"experiment.enqueue_ms_per_step.joint",
            "experiment.copy_ms_per_step.joint"} <= set(r["metrics"])
