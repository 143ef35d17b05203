"""Loss registry.

Same interface as ``deepatlas_tpu.losses``: ``get_loss_function(name)``
returns a factory; calling it with the reference's ``loss_settings`` kwargs
yields the loss callable.  Ported so far: ``dice`` and the registration
losses (``ncc``, ``lncc``, ``mse``, ``gradient``, ``bendingEnergy``, ``L2``);
the other keys of the JAX registry raise and point at ROADMAP.md.  The
``axis_name`` settings of the JAX registry (depth-sharded losses) belong to
the parallel tiers and have no counterpart yet.
"""
from __future__ import annotations

from functools import partial

from .dice import (dice_loss_multiclass, dice_loss_on_label,
                   soft_dice_on_probs)
from .regularizers import bending_energy_loss, gradient_loss, l2_loss
from .similarity import (lncc_loss, mse_loss, multiscale_lncc_loss, ncc_loss)

__all__ = ["dice_loss_multiclass", "dice_loss_on_label",
           "soft_dice_on_probs", "bending_energy_loss", "gradient_loss",
           "l2_loss", "lncc_loss", "mse_loss", "multiscale_lncc_loss",
           "ncc_loss", "get_loss_function", "get_available_losses",
           "loss_dict"]


def _dice_factory(**kw):
    return partial(dice_loss_multiclass,
                   n_class=kw.get("n_class"),
                   weight_type=kw.get("weight_type", "Simple"),
                   no_bg=kw.get("no_bg", False),
                   softmax=kw.get("softmax", False),
                   eps=kw.get("eps", 1e-7))


def _lncc_factory(**kw):
    return partial(lncc_loss, filter_size=kw.get("filter_size", 9),
                   eps=kw.get("eps", 1e-6))


def _ncc_factory(**kw):
    return ncc_loss


def _mse_factory(**kw):
    return mse_loss


def _gradient_factory(**kw):
    return partial(gradient_loss, norm=kw.get("norm", "L2"),
                   spacing=kw.get("spacing", (1.0, 1.0, 1.0)),
                   normalize=kw.get("normalize", True))


def _bending_factory(**kw):
    return partial(bending_energy_loss, norm=kw.get("norm", "L2"),
                   spacing=kw.get("spacing", (1.0, 1.0, 1.0)),
                   normalize=kw.get("normalize", True))


def _l2_factory(**kw):
    return l2_loss


loss_dict = {
    "ncc": _ncc_factory,
    "lncc": _lncc_factory,
    "mse": _mse_factory,
    "gradient": _gradient_factory,
    "bendingEnergy": _bending_factory,
    "dice": _dice_factory,
    "L2": _l2_factory,
}

# keys of the JAX registry whose port comes with a later slice
_NOT_PORTED = ("focal", "cross_entropy", "soft_cross_entropy")


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
