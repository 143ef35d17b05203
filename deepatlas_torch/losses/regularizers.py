"""Deformation-field regularizers on channel-last ``(B, D, H, W, 3)``
displacement fields.

Counterpart of ``deepatlas_tpu/losses/regularizers.py``: the first-order
(central-difference) gradient penalty, the second-order bending energy
(3 diagonal + 3 cross second derivatives) and the mean squared magnitude.
As in the JAX package the gradient penalty is the intended central
difference ``f(x+h) - f(x-h)`` on all three axes.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _prep_spacing(spacing: Sequence[float], normalize: bool,
                  device) -> torch.Tensor:
    s = torch.tensor([float(v) for v in spacing], dtype=torch.float32,
                     device=device)
    return s / s.min() if normalize else s


def _spatial_dims(field: torch.Tensor, normalize: bool) -> torch.Tensor:
    dims = torch.tensor([float(n) for n in field.shape[1:4]],
                        dtype=torch.float32, device=field.device)
    return dims / dims.min() if normalize else dims


def gradient_loss(field: torch.Tensor, norm: str = "L2",
                  spacing: Sequence[float] = (1.0, 1.0, 1.0),
                  normalize: bool = True) -> torch.Tensor:
    """First-order (central-difference) smoothness penalty."""
    sp = _prep_spacing(spacing, normalize, field.device)
    dims = _spatial_dims(field, normalize)
    b, c = field.shape[0], field.shape[-1]

    d0 = (field[:, 2:] - field[:, :-2]).abs().reshape(b, -1, c)
    d1 = (field[:, :, 2:] - field[:, :, :-2]).abs().reshape(b, -1, c)
    d2 = (field[:, :, :, 2:] - field[:, :, :, :-2]).abs().reshape(b, -1, c)

    if norm == "L2":
        d0 = (d0 ** 2).mean(dim=1) * (dims * sp / sp[0]) ** 2
        d1 = (d1 ** 2).mean(dim=1) * (dims * sp / sp[1]) ** 2
        d2 = (d2 ** 2).mean(dim=1) * (dims * sp / sp[2]) ** 2
    return (d0.mean() + d1.mean() + d2.mean()) / 3.0


def bending_energy_loss(field: torch.Tensor, norm: str = "L2",
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        normalize: bool = True) -> torch.Tensor:
    """Second-order bending-energy penalty over the interior voxels, with
    the per-component scale factors ``dims * sp / sp[a]^2`` (``dims`` the
    field's sides over the smallest one when ``normalize``)."""
    sp = _prep_spacing(spacing, normalize, field.device)
    dims = _spatial_dims(field, normalize)
    b, c = field.shape[0], field.shape[-1]
    f = field
    inner = f[:, 1:-1, 1:-1, 1:-1]

    def term(x):
        return (x ** 2 if norm == "L2" else x.abs()).reshape(
            b, -1, c).mean(dim=1)

    dd0 = term(f[:, 2:, 1:-1, 1:-1] + f[:, :-2, 1:-1, 1:-1] - 2 * inner)
    dd1 = term(f[:, 1:-1, 2:, 1:-1] + f[:, 1:-1, :-2, 1:-1] - 2 * inner)
    dd2 = term(f[:, 1:-1, 1:-1, 2:] + f[:, 1:-1, 1:-1, :-2] - 2 * inner)
    d01 = term(f[:, 2:, 2:, 1:-1] + f[:, :-2, :-2, 1:-1]
               - f[:, 2:, :-2, 1:-1] - f[:, :-2, 2:, 1:-1])
    d12 = term(f[:, 1:-1, 2:, 2:] + f[:, 1:-1, :-2, :-2]
               - f[:, 1:-1, 2:, :-2] - f[:, 1:-1, :-2, 2:])
    d02 = term(f[:, 2:, 1:-1, 2:] + f[:, :-2, 1:-1, :-2]
               - f[:, 2:, 1:-1, :-2] - f[:, :-2, 1:-1, 2:])

    if norm == "L2":
        dd0 = dd0 * (dims * sp / sp[0] ** 2) ** 2
        dd1 = dd1 * (dims * sp / sp[1] ** 2) ** 2
        dd2 = dd2 * (dims * sp / sp[2] ** 2) ** 2
        d01 = d01 * (dims * sp / (sp[0] * sp[1])) ** 2
        d12 = d12 * (dims * sp / (sp[1] * sp[2])) ** 2
        d02 = d02 * (dims * sp / (sp[2] * sp[0])) ** 2

    return (dd0.mean() + dd1.mean() + dd2.mean()
            + 2 * d01.mean() + 2 * d12.mean() + 2 * d02.mean()) / 9.0


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean squared magnitude."""
    return torch.mean(x ** 2)
