"""Jacobian-determinant statistics of dense deformation fields.

Counterpart of ``deepatlas_tpu/metrics/jacobian.py``.  The deformation is
the normalized ``(B, D, H, W, 3)`` grid (identity + displacement, last axis
(x, y, z)); determinants are taken in voxel units, so the identity has
determinant 1 everywhere.
"""
from __future__ import annotations

import torch


def jacobian_determinant(deform: torch.Tensor) -> torch.Tensor:
    """Per-voxel Jacobian determinant by central differences:
    ``(B, D-2, H-2, W-2)`` from a ``(B, D, H, W, 3)`` normalized field."""
    b, d, h, w, _ = deform.shape
    scale = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0, (d - 1) / 2.0],
                         dtype=deform.dtype, device=deform.device)
    phi = deform * scale

    # central differences along D (z index), H (y index), W (x index)
    d_z = (phi[:, 2:, 1:-1, 1:-1] - phi[:, :-2, 1:-1, 1:-1]) / 2.0
    d_y = (phi[:, 1:-1, 2:, 1:-1] - phi[:, 1:-1, :-2, 1:-1]) / 2.0
    d_x = (phi[:, 1:-1, 1:-1, 2:] - phi[:, 1:-1, 1:-1, :-2]) / 2.0

    # rows: d(phi_x, phi_y, phi_z); columns: d/dx, d/dy, d/dz
    j00, j01, j02 = d_x[..., 0], d_y[..., 0], d_z[..., 0]
    j10, j11, j12 = d_x[..., 1], d_y[..., 1], d_z[..., 1]
    j20, j21, j22 = d_x[..., 2], d_y[..., 2], d_z[..., 2]

    return (j00 * (j11 * j22 - j12 * j21)
            - j01 * (j10 * j22 - j12 * j20)
            + j02 * (j10 * j21 - j11 * j20))


def folding_stats(deform: torch.Tensor) -> dict:
    """Fraction of voxels with a non-positive Jacobian determinant, and the
    determinant's mean, (population) standard deviation and minimum."""
    det = jacobian_determinant(deform)
    return {
        "folding_fraction": (det <= 0).float().mean(),
        "det_mean": det.mean(),
        "det_std": det.std(unbiased=False),
        "det_min": det.min(),
    }
