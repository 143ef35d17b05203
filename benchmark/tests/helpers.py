"""Shared by the benchmark's tests: the harness on the CPU at tiny shapes."""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# the configurations at sizes a CPU test holds: the published widths, tiny
# volumes (MindBoggle's crop leaves 16^3), a 2-volume OAI cohort of 20 x 40
# x 40 in 16^3 tiles
TINY_MB = {"config": {"shrunk": True, "volume_shape": [16, 20, 18],
                      "crop_size": [0, 2, 1, 0, 2, 1]}}
TINY_OAI = {"config": {"shrunk": True, "volume_shape": [20, 40, 40],
                       "tile": [16, 16, 16], "overlap": [2, 2, 2]},
            "traffic": {"n_volumes": 2, "list_repeats": 3,
                        "checked_volumes": 2}}


# cells that the manifest does not hold but whose job the tests still drive
# (the joint cell waits on a fault of the program: PERF.md, Open questions)
OFF_MANIFEST = {"mb101_joint_preload": {
    "name": "mb101_joint_preload", "config": "deepatlas_mb101",
    "traffic": "joint_preload", "chips": 1,
    "why": "joint alternating training on 21 preloaded volumes, 7 labelled"}}


def tiny(cell: str) -> dict:
    return TINY_OAI if cell.startswith("oai") else TINY_MB


def run_tiny(cell: str, tmp_path, seed: int = 2 ** 31 + 99,
             seconds: float = 1.0, trace: bool = False) -> dict:
    import torch

    import harness
    torch.set_num_threads(4)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            workdir=str(tmp_path / "work"),
                            overrides=tiny(cell),
                            entry=OFF_MANIFEST.get(cell))
