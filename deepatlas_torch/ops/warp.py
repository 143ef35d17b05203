"""Spatial transformer: dense trilinear / nearest warping of 3-D volumes.

Counterpart of ``deepatlas_tpu/ops/warp.py``, with the semantics of
``F.grid_sample(vol, grid, mode='bilinear', padding_mode='zeros',
align_corners=True)``:

  * grid coordinates are normalized to [-1, 1], align_corners=True;
  * the last grid axis is ordered ``(x, y, z)``: x indexes W, y indexes H,
    z indexes D;
  * zero padding: an out-of-bounds *corner* contributes zero (in-bounds
    corners near the border still blend).

The trilinear mode runs on the hand-written warp kernels
(``deepatlas_torch.kernels.grid_sample``, unclamped); the nearest mode, used
for label masks, is one gather in plain tensor ops, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch

from .grid import identity_grid_batch


def unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """Map [-1, 1] (align_corners=True) to [0, size-1] voxel coordinates."""
    return (coord + 1.0) * ((size - 1) / 2.0)


def _check(vol: torch.Tensor, grid: torch.Tensor) -> None:
    if vol.dim() != 5 or grid.dim() != 5 or grid.shape[-1] != 3 \
            or grid.shape[0] != vol.shape[0]:
        raise ValueError(
            f"grid_sample expects vol (B,D,H,W,C) and grid (B,Do,Ho,Wo,3); "
            f"got {tuple(vol.shape)} and {tuple(grid.shape)}")


def grid_sample(vol: torch.Tensor, grid: torch.Tensor,
                mode: str = "trilinear") -> torch.Tensor:
    """Sample ``vol`` ``(B, D, H, W, C)`` at the normalized locations
    ``grid`` ``(B, Do, Ho, Wo, 3)``; zeros outside the source extent.
    ``mode`` is "trilinear" or "nearest" (round half to even, like the
    PyTorch kernel)."""
    _check(vol, grid)
    if mode == "trilinear":
        from ..kernels.warp import grid_sample as kernel_grid_sample

        return kernel_grid_sample(vol, grid, max_disp=None)
    if mode != "nearest":
        raise ValueError(f"Unknown warp mode: {mode!r}")
    b, d, h, w, c = vol.shape
    grid = grid.float()
    ix = torch.round(unnormalize(grid[..., 0], w)).reshape(b, -1)
    iy = torch.round(unnormalize(grid[..., 1], h)).reshape(b, -1)
    iz = torch.round(unnormalize(grid[..., 2], d)).reshape(b, -1)
    inb = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
           & (iz >= 0) & (iz <= d - 1))
    idx = ((iz.clamp(0, d - 1).long() * h + iy.clamp(0, h - 1).long()) * w
           + ix.clamp(0, w - 1).long())
    vals = torch.gather(vol.reshape(b, d * h * w, c), 1,
                        idx[..., None].expand(-1, -1, c))
    out = vals * inb[..., None].to(vol.dtype)
    return out.reshape(b, *grid.shape[1:4], c)


def warp(vol: torch.Tensor, disp: torch.Tensor,
         mode: str = "trilinear") -> torch.Tensor:
    """Warp ``vol`` by a normalized displacement field ``(B, D, H, W, 3)``:
    sample at ``disp + identity``."""
    deform = disp + identity_grid_batch(disp.shape, dtype=disp.dtype,
                                        device=disp.device)
    return grid_sample(vol, deform, mode=mode)


def displacement_overflow(grid: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Fraction of sample points of a ``(B, D, H, W, 3)`` normalized
    deformation whose |displacement| exceeds ``max_disp`` voxels on any
    axis: how much of a field the clamped warp saturates."""
    b, d, h, w, _ = grid.shape
    disp = grid.float() - identity_grid_batch((b, d, h, w), device=grid.device)
    scale = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0, (d - 1) / 2.0],
                         dtype=torch.float32, device=grid.device)
    over = (disp.abs() * scale > max_disp).any(dim=-1)
    return over.float().mean()


def clamp_displacement(grid: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Clamp a normalized deformation grid so each axis' displacement stays
    within +-``max_disp`` voxels of the identity, in float32 and in
    normalized units.  Inside the bound this is the identity map; beyond it
    the warp saturates, and autograd passes no gradient to the field past
    the bound."""
    b, d, h, w, _ = grid.shape
    ident = identity_grid_batch((b, d, h, w), device=grid.device)
    disp = grid.float() - ident
    # normalized units per voxel on each axis (x, y, z)
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1), 2.0 / (d - 1)],
                         dtype=torch.float32, device=grid.device)
    bound = max_disp * scale
    return (ident + torch.clamp(disp, -bound, bound)).to(grid.dtype)


def warp_values_adjoint(warp_fn: Callable, ct: torch.Tensor,
                        deform: torch.Tensor) -> torch.Tensor:
    """Transpose of a warp that is linear in its values: the trilinear
    splat.  For ``warp_fn(vol, deform)`` linear in ``vol`` this satisfies

        <warp_fn(v, deform), ct> == <v, warp_values_adjoint(warp_fn, ct,
                                       deform)>

    per channel: the warp's values-gradient applied to ``ct``, taken at a
    zeros primal (through the kernels' ``grid_sample`` that is one warp of
    the zeros, which eager autograd cannot skip, and one splat)."""
    with torch.enable_grad():
        primal = torch.zeros_like(ct, requires_grad=True)
        out = warp_fn(primal, deform.detach())
        (adj,) = torch.autograd.grad(out, primal, ct)
    return adj


def warp_labels(labels: torch.Tensor, deform: torch.Tensor) -> torch.Tensor:
    """Warp an integer mask ``(B, D, H, W)`` with nearest-neighbour sampling
    at the dense deformation ``(B, D, H, W, 3)``; same dtype as the input."""
    vol = labels[..., None].to(deform.dtype)
    out = grid_sample(vol, deform, mode="nearest")
    return out[..., 0].to(labels.dtype)
