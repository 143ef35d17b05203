"""The control on the card, at each cell's own size: the reference computed
with float8 convolutions in the program's place has to fail at least one of
the cell's limits, where the program on the same seed passes them all.
Needs a CUDA device (about a minute a cell):

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""
from __future__ import annotations

import json
import os

import pytest

from helpers import BENCH, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode at the cells' sizes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_program_passes(cell, card, tmp_path):
    import harness
    path = os.path.join(BENCH, "limits", cell + ".json")
    if not os.path.exists(path):
        pytest.fail(f"{cell} has no limits")
    with open(path) as f:
        limits = {k: v["limit"] for k, v in json.load(f).items()}
    seconds = 6.0 if cell.startswith("oai") else 0.0
    r = harness.run_cell(cell, 2 ** 31 + 4242, seconds, False,
                         workdir=str(tmp_path / "w"), control=True)
    assert r["correct"], r["checks"]
    failed = [k for k, lim in limits.items()
              if k in r["control"] and not r["control"][k] <= lim]
    assert failed, r["control"]
