"""Separable windowed sums over 3-D volumes (the local sums of LNCC).

Counterpart of ``deepatlas_tpu/ops/window.py``: a cubic box filter as three
1-D passes.  With unit stride and dilation each pass is a prefix sum and one
difference (O(1) adds per voxel whatever the window); the strided / dilated
windows of the multi-scale LNCC are sums of ``k`` shifted strided slices.
No convolution is called.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

IntOr3 = Union[int, Sequence[int]]


def _as3(v: IntOr3) -> tuple:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected int or length-3 sequence, got {v!r}")
    return t


def window_sum(x: torch.Tensor, window: IntOr3, stride: IntOr3 = 1,
               dilation: IntOr3 = 1) -> torch.Tensor:
    """Valid-padding box-filter sum over the spatial axes of
    ``(B, D, H, W, C)``: what ``F.conv3d`` with a ones kernel of size
    ``window``, ``stride`` and ``dilation`` gives per channel.

    Returns ``(B, D', H', W', C)`` with
    ``D' = floor((D - dilation * (window - 1) - 1) / stride) + 1`` etc.
    """
    win, st, dil = _as3(window), _as3(stride), _as3(dilation)
    out = x
    if st == (1, 1, 1) and dil == (1, 1, 1):
        for axis, k in zip((1, 2, 3), win):
            n = out.shape[axis]
            cs = torch.cumsum(out, dim=axis)
            zero = torch.zeros_like(cs.narrow(axis, 0, 1))
            cs = torch.cat([zero, cs], dim=axis)
            out = cs.narrow(axis, k, n + 1 - k) - cs.narrow(axis, 0, n + 1 - k)
        return out
    for axis, k, s, dl in zip((1, 2, 3), win, st, dil):
        n = out.shape[axis]
        n_out = (n - dl * (k - 1) - 1) // s + 1
        if n_out < 1:
            raise ValueError(f"window {k} (dilation {dl}) does not fit an "
                             f"axis of {n}")
        index = [slice(None)] * out.dim()
        acc = None
        for j in range(k):
            start = j * dl
            index[axis] = slice(start, start + (n_out - 1) * s + 1, s)
            term = out[tuple(index)]
            acc = term if acc is None else acc + term
        out = acc
    return out
