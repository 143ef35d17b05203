"""Experiment lifecycle base.

Counterpart of ``deepatlas_tpu/train/base.py``: ``__init__(config)`` then
``train()`` / ``test()``, with the setup_log / seed / model / loss / data /
optimizer lifecycle.  Scalars go to ``ScalarWriter``, a JSON-lines file
under the tag names the JAX package gives its TensorBoard scalars.
"""
from __future__ import annotations

import json
import logging
import os
import random

import numpy as np
import torch

from ..utils.config import save_dict_to_json


class ScalarWriter:
    """``add_scalar(tag, value, global_step)`` into ``<dir>/scalars.jsonl``,
    one JSON object per line, flushed as written."""

    FILE_NAME = "scalars.jsonl"

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, self.FILE_NAME)
        self._file = open(self.path, "a")

    def add_scalar(self, tag: str, value, global_step: int) -> None:
        self._file.write(json.dumps({"tag": tag, "value": float(value),
                                     "step": int(global_step)}) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


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
