"""Train / eval step factories.

Counterparts of ``deepatlas_tpu/train/steps.py``.  The JAX package fuses
forward, loss, backward and optimizer update into one jitted program on an
immutable ``TrainState``; here the state holds an ``nn.Module`` and a
``torch.optim.Adam`` that a step updates in place (and returns, so callers
read the same as in the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..metrics import multiclass_dice
from ..utils.profiling import annotate


@dataclass
class TrainState:
    """Model (parameters and BatchNorm statistics), optimizer and step
    count."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: nn.Module,
                   learning_rate: float = 1e-3) -> torch.optim.Adam:
    """Adam as ``optax.adam`` defaults it (b1 0.9, b2 0.999, eps 1e-8 added
    outside the root, no weight decay), which is ``torch.optim.Adam``'s
    default arithmetic.  The learning rate is set from the host between
    epochs (``set_learning_rate``)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def make_seg_train_step(criterion: Callable):
    """Returns ``(state, images, labels) -> (state, loss, logits)``: forward
    with train-mode BatchNorm, the criterion on float32 logits, backward
    and one Adam update.  ``loss`` and ``logits`` are detached tensors on
    the model's device.  The step's spans: ``step.forward``, ``step.loss``,
    ``step.backward`` (Adam carries torch's own marker)."""

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        with annotate("step.forward"):
            logits = state.model(images, train=True)
        with annotate("step.loss"):
            loss = criterion(logits.float(), labels)
        with annotate("step.backward"):
            loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach(), logits.detach()

    return train_step


def make_seg_eval_step(n_class: int):
    """Returns ``(state, images, labels) -> (per_class_dice, logits)`` with
    the foreground dice ``(B, n_class - 1)`` computed on the device."""

    def eval_step(state: TrainState, images: torch.Tensor,
                  labels: torch.Tensor):
        with torch.no_grad():
            logits = state.model(images, train=False)
            preds = logits.argmax(dim=-1)
            dice = multiclass_dice(preds, labels, n_class)
        return dice, logits

    return eval_step
