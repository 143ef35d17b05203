"""Spatial-transformer warp + windowed LNCC similarity in one call.

Counterpart of ``deepatlas_tpu/pallas/warp_lncc.py::warp_lncc_loss``: the
warp kernels (``kernels.grid_sample``, with the displacement clamp) followed
by the prefix-sum LNCC.  As in the JAX package it is a composition, not a
monolithic kernel: fusing the two would save one round trip of the warped
volume through device memory and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..losses.similarity import lncc_loss
from .warp import grid_sample


def warp_lncc_loss(moving: torch.Tensor, fixed: torch.Tensor,
                   grid: torch.Tensor, filter_size: int = 9,
                   eps: float = 1e-6, max_disp: Optional[int] = 8
                   ) -> torch.Tensor:
    """1 - mean local CC^2 between ``warp(moving, grid)`` and ``fixed``.

    Args:
      moving, fixed: ``(B, D, H, W, C)`` volumes.
      grid: ``(B, D, H, W, 3)`` normalized sample grid (x, y, z),
        align_corners=True; each axis of its displacement is clamped to
        +-``max_disp`` voxels (None: no clamp).
    """
    warped = grid_sample(moving.float(), grid, max_disp=max_disp)
    return lncc_loss(warped, fixed.float(), filter_size=filter_size, eps=eps)
