"""Separable windowed sums over 3-D volumes (the local sums of LNCC).

Counterpart of ``deepatlas_tpu/ops/window.py``: a cubic box filter as three
1-D passes, no convolution.  With unit stride and dilation each pass sums
``k`` neighbours by doubling: sums of 2, 4, 8, ... neighbours, each the sum
of two of the last, and the window the sum of those its length's binary
digits name (four adds for ``k`` 9 against eight); its backward is the same
pass over the gradient padded by ``k - 1`` zeros on each side, the adjoint
of a valid box filter.  The strided / dilated windows of the multi-scale
LNCC are sums of ``k`` shifted strided slices.

Every partial sum covers part of one window, so a window sum carries
float32 rounding of its own total.  A prefix sum along a whole axis (the
JAX package's design) carries that of the axis's running total instead,
~1e4 for a 9^3 window of [0, 1] squares; on a zero background, where LNCC's
variances are differences near 0, that throws its gradient far off.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

IntOr3 = Union[int, Sequence[int]]


def _as3(v: IntOr3) -> tuple:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected int or length-3 sequence, got {v!r}")
    return t


def _doubling_sum(x: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """``out[i] = x[i] + ... + x[i + k - 1]`` along ``axis``."""
    m = x.shape[axis] - k + 1
    out, pos, part, width = None, 0, x, 1
    while True:
        # part[i] = x[i] + ... + x[i + width - 1]
        if k & width:
            piece = part.narrow(axis, pos, m)
            out = piece if out is None else out + piece
            pos += width
        if 2 * width > k:
            return out
        n = part.shape[axis] - width
        part = part.narrow(axis, 0, n) + part.narrow(axis, width, n)
        width *= 2


class _AxisWindowSum(torch.autograd.Function):
    """``_doubling_sum`` along one axis, with its adjoint as backward."""

    @staticmethod
    def forward(ctx, x, axis, k):
        ctx.axis, ctx.k = axis, k
        return _doubling_sum(x, axis, k)

    @staticmethod
    def backward(ctx, g):
        pad = [0, 0] * (g.dim() - 1 - ctx.axis) + [ctx.k - 1, ctx.k - 1]
        return _doubling_sum(F.pad(g, pad), ctx.axis, ctx.k), None, None


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
            if out.shape[axis] < k:
                raise ValueError(f"window {k} does not fit an axis of "
                                 f"{out.shape[axis]}")
            out = _AxisWindowSum.apply(out, axis, k)
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
