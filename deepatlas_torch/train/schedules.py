"""Learning-rate schedule controllers.

This package's own copy of ``deepatlas_tpu/train/schedules.py`` (the port
imports nothing of the JAX package): host-side controllers with the
semantics of torch's ``MultiStepLR`` and ``ReduceLROnPlateau``, whose
learning rate the experiment writes into the optimizer after each
validation (``train/steps.py::set_learning_rate``).  They are plain Python,
so their state goes into a checkpoint as a dict of numbers.
"""
from __future__ import annotations

from typing import Optional, Sequence


class LRScheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def step(self, metric: Optional[float] = None) -> float:
        """Advance one validation period; returns the new lr."""
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {"lr": self.lr}

    def load_state_dict(self, state: dict) -> None:
        self.lr = state["lr"]


class ConstLR(LRScheduler):
    def step(self, metric=None):
        return self.lr


class MultiStepLR(LRScheduler):
    """lr = base * gamma^(#milestones passed); milestones in epochs
    (``make_scheduler`` resolves the config's fractions of ``n_epochs``)."""

    def __init__(self, base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.2):
        super().__init__(base_lr)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma
        self.epoch = 0

    def step(self, metric=None):
        self.epoch += 1
        passed = sum(1 for m in self.milestones if self.epoch >= m)
        self.lr = self.base_lr * (self.gamma ** passed)
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "epoch": self.epoch}

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.epoch = state["epoch"]


class ReduceLROnPlateau(LRScheduler):
    """Max-mode plateau scheduler with absolute threshold (the reference's
    configuration: patience 100 validations, factor 0.2, threshold 0.003,
    min_lr 1e-5)."""

    def __init__(self, base_lr: float, factor: float = 0.2,
                 patience: int = 100, threshold: float = 0.003,
                 min_lr: float = 1e-5):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("-inf")
        self.bad_count = 0

    def step(self, metric=None):
        if metric is None:
            return self.lr
        if metric > self.best + self.threshold:
            self.best = metric
            self.bad_count = 0
        else:
            self.bad_count += 1
            if self.bad_count > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_count = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "bad_count": self.bad_count}

    def load_state_dict(self, state):
        self.lr = state["lr"]
        self.best = state["best"]
        self.bad_count = state["bad_count"]


def make_scheduler(lr_mode: str, base_lr: float, n_epochs: int,
                   milestones: Optional[Sequence[float]] = None,
                   gamma: float = 0.2,
                   valid_epoch_period: int = 1) -> LRScheduler:
    """Build a scheduler from the experiment's config keys (``lr_mode``,
    ``milestones`` as fractions of ``n_epochs``, ``gamma``)."""
    if lr_mode == "multiStep":
        ms = [int(r * n_epochs) for r in (milestones or [0.5, 1.0])]
        return MultiStepLR(base_lr, ms, gamma)
    if lr_mode == "plateau":
        return ReduceLROnPlateau(base_lr,
                                 patience=100 // max(valid_epoch_period, 1))
    return ConstLR(base_lr)


def scheduler_from_restored(scheduler, state) -> None:
    """Restore a scheduler from checkpoint-restored values (Python or numpy
    scalars; a checkpoint converted from the JAX package holds the latter).
    A checkpoint without scheduler state leaves the scheduler as it is."""
    if not state:
        return
    cast = {}
    for k, v in state.items():
        f = float(v)
        cast[k] = int(f) if k in ("epoch", "bad_count") else f
    scheduler.load_state_dict(cast)
