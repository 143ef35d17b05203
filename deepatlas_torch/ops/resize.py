"""Volume resizing with ``F.interpolate``'s index rules, on channel-last
tensors.

Counterpart of ``deepatlas_tpu/ops/resize.py``.  The VoxelMorph decoder
upsamples with nearest-neighbour to the matching encoder's size, which is not
always a factor of two (11x13x11 -> 21x25x21), so the nearest rule is
torch's ``src = floor(dst * in / out)``.  Both resizes are per-axis index
selections (differentiable; no convolution).
"""
from __future__ import annotations

from typing import Sequence

import torch


def nearest_resize(vol: torch.Tensor, out_shape: Sequence[int]
                   ) -> torch.Tensor:
    """Nearest-neighbour resize of ``(B, D, H, W, C)`` to ``out_shape``."""
    out = vol
    for axis, n_out in zip((1, 2, 3), out_shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        idx = torch.floor(torch.arange(n_out, device=vol.device)
                          * (n_in / n_out)).long().clamp_(0, n_in - 1)
        out = out.index_select(axis, idx)
    return out


def trilinear_resize(vol: torch.Tensor, out_shape: Sequence[int],
                     align_corners: bool = False) -> torch.Tensor:
    """Trilinear resize of ``(B, D, H, W, C)`` to ``out_shape``: separable
    two-tap blends per axis.  ``align_corners=False`` is the half-pixel rule
    ``src = (dst + 0.5) * in / out - 0.5`` with edge clamping,
    ``align_corners=True`` is ``src = dst * (in - 1) / (out - 1)``."""
    out = vol
    for axis, n_out in zip((1, 2, 3), out_shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        dst = torch.arange(n_out, device=vol.device, dtype=torch.float32)
        if align_corners and n_out > 1:
            src = dst * ((n_in - 1) / (n_out - 1))
        elif align_corners:
            src = torch.zeros_like(dst)
        else:
            src = (dst + 0.5) * (n_in / n_out) - 0.5
        src = src.clamp(0.0, n_in - 1)
        lo = torch.floor(src).long()
        hi = (lo + 1).clamp(max=n_in - 1)
        shape = [1] * out.dim()
        shape[axis] = n_out
        frac = (src - lo).to(vol.dtype).reshape(shape)
        out = (out.index_select(axis, lo) * (1 - frac)
               + out.index_select(axis, hi) * frac)
    return out
