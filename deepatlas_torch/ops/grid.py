"""Identity sampling grids for dense deformable transforms.

Counterpart of ``deepatlas_tpu/ops/grid.py``: channel-last ``(D, H, W, 3)``
grids whose last axis is ordered ``(x, y, z)`` -- x indexes W (the fastest
axis), y indexes H, z indexes D -- normalized to ``[-1, 1]`` with the
align-corners rule: voxel ``i`` on an axis of size ``n`` sits at
``-1 + 2 i / (n - 1)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def identity_grid(shape: Sequence[int], normalize: bool = True,
                  dtype: torch.dtype = torch.float32,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Identity sampling grid ``(D, H, W, 3)`` for a ``(D, H, W)`` volume;
    raw voxel indices when ``normalize`` is False."""
    d, h, w = (int(n) for n in shape)

    def axis_coords(n):
        c = torch.arange(n, dtype=dtype, device=device)
        if normalize:
            # a single-voxel axis maps its index 0 to -1
            c = c / (n - 1) * 2.0 - 1.0 if n > 1 else c * 0.0 - 1.0
        return c

    x = axis_coords(w)[None, None, :].expand(d, h, w)
    y = axis_coords(h)[None, :, None].expand(d, h, w)
    z = axis_coords(d)[:, None, None].expand(d, h, w)
    return torch.stack([x, y, z], dim=-1)


def identity_grid_batch(batch_shape: Sequence[int], normalize: bool = True,
                        dtype: torch.dtype = torch.float32,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """Identity grid broadcast over a batch: ``(B, D, H, W, 3)`` from a
    ``(B, D, H, W, ...)`` shape (an expanded view, no copy per sample)."""
    grid = identity_grid(batch_shape[1:4], normalize=normalize, dtype=dtype,
                         device=device)
    return grid[None].expand((int(batch_shape[0]),) + tuple(grid.shape))


def normalize_displacement(disp_voxels: torch.Tensor) -> torch.Tensor:
    """A ``(..., D, H, W, 3)`` displacement in voxel units, last axis
    ``(x, y, z)``, in normalized ``[-1, 1]`` units."""
    d, h, w = disp_voxels.shape[-4:-1]
    scale = torch.tensor(
        [2.0 / max(w - 1, 1), 2.0 / max(h - 1, 1), 2.0 / max(d - 1, 1)],
        dtype=disp_voxels.dtype, device=disp_voxels.device)
    return disp_voxels * scale
