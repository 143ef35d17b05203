"""Runs of the harness, on the CPU at tiny shapes, with the timed path broken
underneath: ``correct`` has to come out false, through the number each
fault moves.  The faults a cell can have: a training step that returns its
state unchanged; a served label altered where it is produced; a served
dice altered where it is produced (``faults.py``); a volume altered where
the loader produces it.  The cells run batch 1 on one chip,
so no batch has a half to leave out and no exchange between chips
exists."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import run_tiny


def failing(result, number):
    c = result["checks"][number]
    assert result["correct"] is False
    assert not c["value"] <= c["limit"], (number, c)
    return c["value"]


@pytest.mark.parametrize("cell", ["mb101_seg_preload", "mb101_joint_preload"])
def test_step_returns_state_unchanged(cell, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    r = run_tiny(cell, tmp_path)
    assert failing(r, "update_gap") == pytest.approx(1.0)


@pytest.mark.parametrize("fault, number", [("labels_plane", "label_gap"),
                                           ("dice_half_planes", "dice_gap")])
def test_served_answer_altered(fault, number, tmp_path):
    import faults
    undo = faults.FAULTS[fault]()
    try:
        r = run_tiny("oai_serve_nifti", tmp_path, seconds=2.0)
    finally:
        undo()
    assert failing(r, number) > 0


@pytest.mark.parametrize("cell", ["mb101_seg_nifti", "oai_serve_nifti"])
def test_loaded_volume_altered(cell, tmp_path, monkeypatch):
    import deepatlas_torch.data.transforms as tf
    orig = tf.VolumeToArray.__call__

    def altered(self, sample):
        sample = orig(self, sample)
        img = sample["image"].copy()
        mid = tuple(n // 2 for n in img.shape)
        img[mid] = np.float32(0.5) - img[mid]
        sample["image"] = img
        return sample

    monkeypatch.setattr(tf.VolumeToArray, "__call__", altered)
    r = run_tiny(cell, tmp_path, seconds=2.0)
    assert failing(r, "data_mismatch") >= 1
