"""Checkpoint save/restore with the reference's periodic + best semantics.

A checkpoint is one ``torch.save`` file of ``{'epoch', 'best_score',
'model'[, 'optimizer', 'scheduler']}`` (``model`` and ``optimizer`` are
state_dicts, ``scheduler`` a dict of numbers), written as
``<path>/checkpoint`` and, when it is the best so far, copied to
``<path>/model_best`` -- the layout of ``deepatlas_tpu/train/checkpoint.py``
with files where orbax writes directories.  Checkpoints of the JAX package
convert with ``tools/flax_ckpt_to_torch.py``.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch

CKPT_NAME = "checkpoint"
BEST_NAME = "model_best"


def save_checkpoint(state: dict, is_best: bool, path: str,
                    prefix: Optional[str] = None) -> str:
    """Save ``state`` (``{'epoch', 'best_score', 'model', ...}``) under
    ``path``; also copy it to the best slot when ``is_best``.  Returns the
    checkpoint file's path."""
    os.makedirs(path, exist_ok=True)
    name = f"{prefix}_{CKPT_NAME}" if prefix else CKPT_NAME
    best = f"{prefix}_{BEST_NAME}" if prefix else BEST_NAME
    target = os.path.join(path, name)
    tmp = target + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)
    if is_best:
        shutil.copyfile(target, os.path.join(path, best))
    return target


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """Load a checkpoint file written by ``save_checkpoint``."""
    if not os.path.isfile(path):
        raise ValueError(f"=> no checkpoint found at '{path}'")
    return torch.load(path, map_location=map_location, weights_only=True)


def initialize_from(path: str, map_location="cpu"
                    ) -> Tuple[dict, int, float]:
    """Restore and unpack ``(state, finished_epoch, best_score)``.  ``path``
    is a checkpoint file, or a directory holding ``checkpoint``; the
    best-score key may be one of the joint-training aliases
    (``reg_best_score`` / ``seg_best_score``)."""
    if os.path.isdir(path):
        path = os.path.join(path, CKPT_NAME)
    state = load_checkpoint(path, map_location)
    for key in ("best_score", "reg_best_score", "seg_best_score"):
        if key in state:
            best_score = float(state[key])
            break
    else:
        raise ValueError("no best score key")
    return state, int(state.get("epoch", 0)), best_score
