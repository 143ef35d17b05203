"""Loss registry.

Same interface as ``deepatlas_tpu.losses``: ``get_loss_function(name)``
returns a factory; calling it with the reference's ``loss_settings`` kwargs
yields the loss callable.  Only ``"dice"`` is ported so far; the other keys
of the JAX registry raise and point at ROADMAP.md.
"""
from __future__ import annotations

from functools import partial

from .dice import (dice_loss_multiclass, dice_loss_on_label,
                   soft_dice_on_probs)

__all__ = ["dice_loss_multiclass", "dice_loss_on_label",
           "soft_dice_on_probs", "get_loss_function",
           "get_available_losses", "loss_dict"]


def _dice_factory(**kw):
    return partial(dice_loss_multiclass,
                   n_class=kw.get("n_class"),
                   weight_type=kw.get("weight_type", "Simple"),
                   no_bg=kw.get("no_bg", False),
                   softmax=kw.get("softmax", False),
                   eps=kw.get("eps", 1e-7))


loss_dict = {"dice": _dice_factory}

# keys of the JAX registry whose port comes with a later slice
_NOT_PORTED = ("ncc", "lncc", "mse", "gradient", "bendingEnergy", "L2",
               "focal", "cross_entropy", "soft_cross_entropy")


def get_loss_function(loss_name: str):
    if loss_name in _NOT_PORTED:
        raise NotImplementedError(
            f"Loss {loss_name!r} is not ported to PyTorch yet; see Queue 1 "
            f"of ROADMAP.md for the slice that brings it")
    if loss_name not in loss_dict:
        raise KeyError(f"Loss {loss_name!r} is not available! "
                       f"Choose from: {tuple(loss_dict)}")
    return loss_dict[loss_name]


def get_available_losses():
    return tuple(loss_dict.keys())
