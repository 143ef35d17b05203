"""Experiment lifecycle base.

Counterpart of ``deepatlas_tpu/train/base.py``: ``__init__(config)`` then
``train()`` / ``test()``, with the setup_log / seed / model / loss / data /
optimizer lifecycle.  Scalars and images go to ``ScalarWriter`` under the
tag names the JAX package gives its TensorBoard summaries: a JSON-lines
file and ``.npy`` files, and TensorBoard event files where the
``tensorboard`` package imports.
"""
from __future__ import annotations

import json
import logging
import os
import random
import sys
import types

import numpy as np
import torch

from ..utils.config import save_dict_to_json


def _summary_writer(log_dir: str):
    """``torch.utils.tensorboard.SummaryWriter(log_dir)``, or None where
    the ``tensorboard`` package does not import.  TensorBoard's TensorFlow
    switch is set to its stub first (``tensorboard.compat.notf``): the
    event files are the same, and the process does not import TensorFlow
    where it happens to be installed."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class ScalarWriter:
    """``add_scalar(tag, value, global_step)`` into ``<dir>/scalars.jsonl``,
    one JSON object per line, flushed as written; ``add_image(tag, img,
    global_step)`` into ``<dir>/images/<tag, "/" as "__">/<step>.npy``.
    Both go to TensorBoard event files in ``<dir>`` too where the
    ``tensorboard`` package imports (``tensorboard`` is None where it does
    not)."""

    FILE_NAME = "scalars.jsonl"
    IMAGE_DIR = "images"

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, self.FILE_NAME)
        self._file = open(self.path, "a")
        self.tensorboard = _summary_writer(log_dir)

    def add_scalar(self, tag: str, value, global_step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(global_step)}) + "\n")
        self._file.flush()
        if self.tensorboard is not None:
            self.tensorboard.add_scalar(tag, float(value), int(global_step))

    def image_path(self, tag: str, global_step: int) -> str:
        return os.path.join(self.log_dir, self.IMAGE_DIR,
                            tag.replace("/", "__"), f"{int(global_step)}.npy")

    def add_image(self, tag: str, img, global_step: int) -> None:
        """``img`` is a ``(3, H, W)`` array in [0, 1], stored as float32."""
        img = np.asarray(img, dtype=np.float32)
        if img.ndim != 3 or img.shape[0] != 3:
            raise ValueError(f"add_image {tag!r}: expected a (3, H, W) "
                             f"image, got {img.shape}")
        path = self.image_path(tag, global_step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, img)
        if self.tensorboard is not None:
            self.tensorboard.add_image(tag, img, int(global_step))

    def close(self) -> None:
        self._file.close()
        if self.tensorboard is not None:
            self.tensorboard.close()


class BaseExperiment:
    def __init__(self, config: dict, **kwargs):
        self.config = dict(config)
        self.writer = None

    # lifecycle hooks -----------------------------------------------------
    def setup_log(self):
        pass

    def setup_random_seed(self):
        """Seed the numpy, Python and torch generators."""
        seed = self.config["random_seed"]
        np.random.seed(seed)
        random.seed(seed)
        torch.manual_seed(seed)

    def setup_train_data(self):
        pass

    def setup_model(self):
        pass

    def setup_loss(self):
        pass

    def setup_optimizer(self):
        pass

    def setup_train(self):
        self.setup_log()
        self.setup_random_seed()
        self.setup_model()
        self.setup_loss()
        self.setup_train_data()
        self.setup_optimizer()

    # helpers -------------------------------------------------------------
    def save_config_snapshot(self, path: str):
        save_dict_to_json(self.config, os.path.join(path,
                                                    "train_config.json"))

    def train(self, **kwargs):
        raise NotImplementedError()

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class test_logger:
    """Context manager yielding a logger that writes ``test_log.txt`` plus
    stderr, with explicit handlers: ``logging.basicConfig`` does nothing
    once an earlier experiment configured the root logger in-process."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self.logger = logging.getLogger(f"deepatlas_torch_test_{id(self)}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        self.fh = logging.FileHandler(self.path)
        self.sh = logging.StreamHandler()
        self.logger.addHandler(self.fh)
        self.logger.addHandler(self.sh)
        return self.logger

    def __exit__(self, *exc):
        self.logger.removeHandler(self.fh)
        self.logger.removeHandler(self.sh)
        self.fh.close()
        return False
