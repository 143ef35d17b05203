"""Hard-label anatomy dice on the matched-label warp: the joint training's
anatomy loss without the dense C-channel one-hot warp.

With hard labels on both sides the anatomy term
``soft_dice_on_probs(warp(one_hot(lab_m)), lab_f)`` reduces to

    inter_c   = sum_p [lab_f(p) = c] m(p),
    m(p)      = sum over corners k of p: w_k(p) [lab_m(corner_k) = lab_f(p)]
    denom_m_c = sum_v [lab_m(v) = c] u(v), u = splat(ones) (the adjoint)

so one gather over labels (``matched_warp``) and one C = 1 splat replace
the C-channel warp.  ``matched_warp`` replaces the TPU kernel
``deepatlas_tpu/pallas/anatomy.py::_matched_fwd_kernel``,
``matched_warp_fused`` (the value with its three derivative planes in one
sweep) ``::_matched_fused_kernel`` and ``matched_grid_grad`` (the grid
cotangent) ``::_matched_bwd_kernel``; ``hard_anatomy_dice`` is the
counterpart of the function of that name there.  The TPU kernels' z-slabs,
lane rolls, offset lists, displacement bound and dense fallbacks exist
because Mosaic has no per-element 3-D gather; a CUDA thread gathers its 8
corners directly (``csrc/anatomy.cu``), so these kernels have no limit of
their own and ``max_disp`` survives only as the clamp applied first.

Labels are integer tensors, converted once per call to int32 for the
kernels (an integer compare is exact; the TPU compares float labels within
0.5) and to int64 for the per-class sums.  The grid is ``(B, D, H, W, 3)``
float32, normalized ``(x, y, z)``, as for ``warp.grid_sample``.

Each wrapper dispatches on its input's device only: a CPU tensor goes to the
plain PyTorch version beside it (the 8-corner gather and compare, and
autograd of it), a CUDA tensor to the CUDA kernel (or the wrapper raises).
``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..ops.warp import clamp_displacement
from . import build
from .warp import _corners, _stream, splat_ones, warp_grid_grad

_P, _I = ctypes.c_void_p, ctypes.c_int
_DIMS = [_I] * 7
_SIGNATURES = {
    "matched_warp": [_P, _P, _P, _P, *_DIMS, _P],
    "matched_warp_fused": [_P, _P, _P, _P, _P, *_DIMS, _P],
    "matched_grid_grad": [_P, _P, _P, _P, _P, *_DIMS, _P],
}


def _check(what: str, lab_m: torch.Tensor, lab_f: torch.Tensor,
           grid: torch.Tensor) -> None:
    """``lab_m`` ``(B, D, H, W)`` int32 (the moving labels, sampled);
    ``lab_f`` int32 and ``grid`` ``(B, Do, Ho, Wo[, 3])`` float32 at the
    sample points; all contiguous on one device."""
    if lab_m.dim() != 4 or grid.dim() != 5 or grid.shape[-1] != 3 \
            or lab_f.shape != grid.shape[:4] \
            or lab_m.shape[0] != grid.shape[0]:
        raise ValueError(f"{what}: expected (B, D, H, W) moving labels, "
                         f"(B, Do, Ho, Wo) fixed labels and a (B, Do, Ho, "
                         f"Wo, 3) grid, got {tuple(lab_m.shape)}, "
                         f"{tuple(lab_f.shape)} and {tuple(grid.shape)}")
    if lab_m.dtype != torch.int32 or lab_f.dtype != torch.int32:
        raise TypeError(f"{what}: labels must be int32, got {lab_m.dtype} "
                        f"and {lab_f.dtype}")
    if grid.dtype != torch.float32:
        raise TypeError(f"{what}: the grid must be float32, got {grid.dtype}")
    if not (lab_m.is_contiguous() and lab_f.is_contiguous()
            and grid.is_contiguous()):
        raise ValueError(f"{what}: labels and grid must be contiguous")
    if not lab_m.device == lab_f.device == grid.device:
        raise ValueError(f"{what}: operands on {lab_m.device}, "
                         f"{lab_f.device} and {grid.device}")
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {grid.device}")


def _check_ct(ct: torch.Tensor, grid: torch.Tensor) -> None:
    if ct.shape != grid.shape[:4] or ct.dtype != torch.float32 \
            or not ct.is_contiguous() or ct.device != grid.device:
        raise ValueError(f"matched_grid_grad: ct must be a contiguous "
                         f"float32 {tuple(grid.shape[:4])} tensor on "
                         f"{grid.device}, got {tuple(ct.shape)} {ct.dtype} "
                         f"on {ct.device}")


def _dims(lab_m, grid):
    return (*lab_m.shape, *grid.shape[1:4])


# ------------------------------------------------------- plain versions

def _matched_math(lab_m, lab_f, grid):
    """m at every grid point; differentiable in the grid through the corner
    weights (at fixed corners: the floor rule)."""
    b, d, h, w = lab_m.shape
    flat_m = lab_m.reshape(-1)
    flat_f = lab_f.reshape(-1)
    out = None
    for idx, weight in _corners(grid, d, h, w):
        term = weight * (flat_m.index_select(0, idx) == flat_f).float()
        out = term if out is None else out + term
    return out.reshape(grid.shape[:4])


def _fused_math(lab_m, lab_f, grid):
    with torch.enable_grad():
        g = grid.detach().requires_grad_(True)
        m = _matched_math(lab_m, lab_f, g)
        # m(p) depends on grid(p) only, so the gradient of the sum is the
        # per-point derivative
        (planes,) = torch.autograd.grad(m.sum(), g)
    return m.detach(), planes


def _grid_grad_math(lab_m, lab_f, grid, ct):
    with torch.enable_grad():
        g = grid.detach().requires_grad_(True)
        m = _matched_math(lab_m, lab_f, g)
        (dgrid,) = torch.autograd.grad(m, g, ct)
    return dgrid


def matched_warp_plain(lab_m: torch.Tensor, lab_f: torch.Tensor,
                       grid: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``matched_warp``: 8 label gathers
    (``index_select``) compared with ``lab_f`` and blended with the corner
    weights.  Differentiable in the grid; its autograd is the plain version
    of the other two kernels."""
    _check("matched_warp", lab_m, lab_f, grid)
    return _matched_math(lab_m, lab_f, grid)


def matched_warp_fused_plain(lab_m: torch.Tensor, lab_f: torch.Tensor,
                             grid: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``matched_warp_fused``: ``matched_warp_plain``
    and its autograd with respect to the grid."""
    _check("matched_warp_fused", lab_m, lab_f, grid)
    return _fused_math(lab_m, lab_f, grid)


def matched_grid_grad_plain(lab_m: torch.Tensor, lab_f: torch.Tensor,
                            grid: torch.Tensor, ct: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of ``matched_grid_grad``: autograd of
    ``matched_warp_plain`` for the cotangent ``ct``."""
    _check("matched_grid_grad", lab_m, lab_f, grid)
    _check_ct(ct, grid)
    return _grid_grad_math(lab_m, lab_f, grid, ct)


# ------------------------------------------------------------- kernels

def _matched_cuda(lab_m, lab_f, grid):
    m = torch.empty(grid.shape[:4], dtype=torch.float32, device=grid.device)
    lib = build.load("anatomy", _SIGNATURES)
    with torch.cuda.device(grid.device):
        rc = lib.matched_warp(lab_m.data_ptr(), lab_f.data_ptr(),
                              grid.data_ptr(), m.data_ptr(),
                              *_dims(lab_m, grid), _stream(grid))
    build.check(rc, "matched_warp")
    matched_warp.launches += 1
    return m


def _fused_cuda(lab_m, lab_f, grid):
    m = torch.empty(grid.shape[:4], dtype=torch.float32, device=grid.device)
    planes = torch.empty_like(grid)
    lib = build.load("anatomy", _SIGNATURES)
    with torch.cuda.device(grid.device):
        rc = lib.matched_warp_fused(lab_m.data_ptr(), lab_f.data_ptr(),
                                    grid.data_ptr(), m.data_ptr(),
                                    planes.data_ptr(), *_dims(lab_m, grid),
                                    _stream(grid))
    build.check(rc, "matched_warp_fused")
    matched_warp_fused.launches += 1
    return m, planes


def _grid_grad_cuda(lab_m, lab_f, grid, ct):
    dgrid = torch.empty_like(grid)
    lib = build.load("anatomy", _SIGNATURES)
    with torch.cuda.device(grid.device):
        rc = lib.matched_grid_grad(lab_m.data_ptr(), lab_f.data_ptr(),
                                   grid.data_ptr(), ct.data_ptr(),
                                   dgrid.data_ptr(), *_dims(lab_m, grid),
                                   _stream(grid))
    build.check(rc, "matched_grid_grad")
    matched_grid_grad.launches += 1
    return dgrid


def matched_warp(lab_m: torch.Tensor, lab_f: torch.Tensor,
                 grid: torch.Tensor) -> torch.Tensor:
    """The matched-label warp (forward only, no clamp)::

        m[b, p] = sum over the 8 corners k of p:
                  w_k [lab_m[b, corner_k] == lab_f[b, p]]

    a corner outside the volume contributing nothing: channel
    ``lab_f[b, p]`` of the trilinear warp of ``one_hot(lab_m)``.

    Args:
      lab_m: ``(B, D, H, W)`` int32, contiguous.
      lab_f: ``(B, Do, Ho, Wo)`` int32.
      grid: ``(B, Do, Ho, Wo, 3)`` float32 normalized ``(x, y, z)``.

    Returns ``(B, Do, Ho, Wo)`` float32.
    """
    _check("matched_warp", lab_m, lab_f, grid)
    if grid.device.type == "cpu":
        return _matched_math(lab_m, lab_f, grid)
    return _matched_cuda(lab_m, lab_f, grid)


matched_warp.launches = 0


def matched_warp_fused(lab_m: torch.Tensor, lab_f: torch.Tensor,
                       grid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``matched_warp`` and its derivative with respect to the grid in one
    sweep: returns ``(m, planes)`` with ``planes`` ``(B, Do, Ho, Wo, 3)``
    float32 = dm/dgrid in the grid's normalized units, order x, y, z (the
    layout and scaling of ``warp_grid_grad``'s output), so that the grid
    cotangent of ``m`` is ``ct[..., None] * planes``.

    The derivative is that of the corner weights at fixed corners (the floor
    rule, which is also what autograd of the plain version gives): at an
    exactly integral coordinate it is the one-sided derivative towards the
    upper corner, where the TPU kernel's tent form returns 0."""
    _check("matched_warp_fused", lab_m, lab_f, grid)
    if grid.device.type == "cpu":
        return _fused_math(lab_m, lab_f, grid)
    return _fused_cuda(lab_m, lab_f, grid)


matched_warp_fused.launches = 0


def matched_grid_grad(lab_m: torch.Tensor, lab_f: torch.Tensor,
                      grid: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Gradient of ``sum(matched_warp(lab_m, lab_f, grid) * ct)`` with
    respect to the grid: ``ct[..., None] * planes`` of
    ``matched_warp_fused`` (the same floor rule), without writing ``m``.

    Args:
      ct: ``(B, Do, Ho, Wo)`` float32, contiguous.

    Returns ``(B, Do, Ho, Wo, 3)`` float32.
    """
    _check("matched_grid_grad", lab_m, lab_f, grid)
    _check_ct(ct, grid)
    if grid.device.type == "cpu":
        return _grid_grad_math(lab_m, lab_f, grid, ct)
    return _grid_grad_cuda(lab_m, lab_f, grid, ct)


matched_grid_grad.launches = 0


# ------------------------------------------------ differentiable pieces

class _Matched(torch.autograd.Function):
    """``m`` with its grid gradient: with ``fused`` (and a grid that needs a
    gradient) the forward is ``matched_warp_fused`` and the backward
    elementwise; otherwise the forward is ``matched_warp`` and the backward
    ``matched_grid_grad``."""

    @staticmethod
    def forward(ctx, lab_m, lab_f, grid, fused):
        ctx.fused = fused and ctx.needs_input_grad[2]
        if ctx.fused:
            m, planes = matched_warp_fused(lab_m, lab_f, grid)
            ctx.save_for_backward(planes)
        else:
            m = matched_warp(lab_m, lab_f, grid)
            ctx.save_for_backward(lab_m, lab_f, grid)
        return m

    @staticmethod
    def backward(ctx, ct):
        ct = ct.float().contiguous()
        if ctx.fused:
            (planes,) = ctx.saved_tensors
            return None, None, ct[..., None] * planes, None
        lab_m, lab_f, grid = ctx.saved_tensors
        return None, None, matched_grid_grad(lab_m, lab_f, grid, ct), None


class _SplatOnes(torch.autograd.Function):
    """``u = splat(ones)``, the total warp weight each source voxel
    receives ``(B, D, H, W)``; the gradient of ``sum(ct * u)`` in the grid
    is the grid gradient of ``warp(ct)`` for a unit cotangent."""

    @staticmethod
    def forward(ctx, grid, dhw):
        ctx.save_for_backward(grid)
        return splat_ones(grid, dhw)[..., 0]

    @staticmethod
    def backward(ctx, ct):
        (grid,) = ctx.saved_tensors
        ones = torch.ones(*grid.shape[:4], 1, dtype=torch.float32,
                          device=grid.device)
        dgrid = warp_grid_grad(ct.float()[..., None].contiguous(), grid, ones)
        return dgrid, None


# partial sums per class in binned_sum: neighbouring elements, which mostly
# share a label, add into different slots instead of contending for one
_BIN_LANES = 256


def _fixed_scale(amax: torch.Tensor, n: int) -> torch.Tensor:
    """binned_sum's scale ``2^e`` (float64): ``n * amax * 2^e <= 2^52``, so
    that every partial sum of ``n`` integer terms of at most ``amax * 2^e``
    is an integer that float64 holds exactly (``amax < 2^ex`` by
    ``frexp``); on the device, without a sync."""
    lg = max(int(n) - 1, 0).bit_length()          # ceil(log2 n)
    ex = torch.frexp(amax)[1].to(torch.float64)
    return torch.exp2((52 - lg) - ex)


class _BinnedSum(torch.autograd.Function):
    """binned_sum's forward in fixed point; the backward gathers the
    cotangent of each element's class."""

    @staticmethod
    def forward(ctx, values, labels, n_class):
        v = values.reshape(-1).double()
        lab = labels.reshape(-1).long()
        valid = (lab >= 0) & (lab < n_class)
        cls = lab.clamp(0, n_class - 1)
        v = torch.where(valid, v, torch.zeros_like(v))
        finite = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        amax = finite.abs().amax() if v.numel() else v.new_zeros(())
        scale = _fixed_scale(amax, v.numel())
        # v * 2^e is exact in float64 (a float32 times a power of two), its
        # rint an integer; float64 adds such integers exactly while every
        # partial sum stays under 2^53, so the sums do not depend on the
        # order of the card's atomics.  A NaN or an infinity stays one.
        terms = torch.round(v * scale)
        lane = torch.arange(v.numel(), device=v.device) % _BIN_LANES
        partial = torch.zeros(n_class * _BIN_LANES, dtype=torch.float64,
                              device=v.device)
        partial.index_add_(0, cls * _BIN_LANES + lane, terms)
        sums = partial.view(n_class, _BIN_LANES).sum(dim=1)
        ctx.save_for_backward(cls, valid)
        ctx.shape, ctx.dtype = values.shape, values.dtype
        return (sums / scale).float()

    @staticmethod
    def backward(ctx, g):
        cls, valid = ctx.saved_tensors
        dv = torch.where(valid, g.float().index_select(0, cls),
                         torch.zeros((), dtype=torch.float32,
                                     device=g.device))
        return dv.reshape(ctx.shape).to(ctx.dtype), None, None


def binned_sum(values: torch.Tensor, labels: torch.Tensor,
               n_class: int) -> torch.Tensor:
    """The sum of ``values`` per label: ``(n_class,)`` float32, over the
    flattened tensors (differentiable in ``values``; the backward is a
    gather).  A label outside ``[0, n_class)`` counts in no class, as a zero
    row of ``one_hot``.

    The sums are the same bits in whatever order the elements are added
    (the reference, a chunked one-hot matrix product, is deterministic
    too): each value is scaled by ``2^e`` with ``n * max|v| * 2^e <= 2^52``
    (``n`` the elements) and rounded to an integer; float64 adds such
    integers exactly, so the sums of ``index_add_``, whose atomics on the
    card land in any order, are exact integers; each class's sum is scaled
    back and rounded to float32.  That is within ``2^-e`` a term of the
    exact sum (``2^-28`` of the largest value at 5.6 M elements), far
    inside float32's rounding of a class's sum.  (float64 and not int64:
    PyTorch adds int64 on the card by compare-and-swap loops, ten times
    slower under the contention of 32 classes.)  Element ``i`` adds into
    lane ``i % 256`` of its class and the lanes are summed after, so that
    the atomics spread over ``256 * n_class`` addresses.  A class that
    holds a NaN sums to NaN, one that holds an infinity to an infinity or
    NaN."""
    return _BinnedSum.apply(values, labels, int(n_class))


def hard_anatomy_dice(lab_m: torch.Tensor, lab_f: torch.Tensor,
                      deform: torch.Tensor, n_class: int, *,
                      max_disp: int = 8, eps: float = 1e-5,
                      fused_grad: bool = False) -> torch.Tensor:
    """Exactly ``soft_dice_on_probs(grid_sample(one_hot(lab_m), deform),
    lab_f, n_class)`` (foreground classes 1..C-1, ``eps`` 1e-5) for HARD
    labels on both sides, at the cost of one C = 1 warp.

    Args:
      lab_m, lab_f: ``(B, D, H, W)`` integer masks.
      deform: ``(B, D, H, W, 3)`` normalized (x, y, z) deformation; each
        axis of its displacement is clamped to +-``max_disp`` voxels first
        (``ops.clamp_displacement``, the warp's clamp).
      fused_grad: compute the derivative planes in the forward
        (``matched_warp_fused``, whose backward is elementwise) where the
        loss will be differentiated, as the joint reg step does; leave False
        for a value-only use (``matched_warp``, with ``matched_grid_grad``
        as its backward).

    Differentiable in ``deform`` only.  Launches one matched-warp kernel and
    one splat (of ones) forward, and one grid-gradient kernel backward.
    """
    if lab_m.dim() != 4 or lab_f.shape != lab_m.shape \
            or deform.shape != lab_m.shape + (3,):
        raise ValueError(f"hard_anatomy_dice: expected (B, D, H, W) labels "
                         f"and a (B, D, H, W, 3) deformation, got "
                         f"{tuple(lab_m.shape)}, {tuple(lab_f.shape)} and "
                         f"{tuple(deform.shape)}")
    grid = clamp_displacement(deform, max_disp).float().contiguous()
    lm = lab_m.to(torch.int32).contiguous()
    lf = lab_f.to(torch.int32).contiguous()
    m = _Matched.apply(lm, lf, grid, fused_grad)
    u = _SplatOnes.apply(grid, tuple(lm.shape[1:]))
    lm, lf = lm.long(), lf.long()

    def per_class(values, labels):
        return torch.stack([binned_sum(values[i], labels[i], n_class)
                            for i in range(labels.shape[0])])[:, 1:]

    inter = per_class(m, lf)
    denom = per_class(u, lm) + per_class(torch.ones_like(m), lf)
    scores = 2.0 * inter / (denom + eps)
    return 1.0 - scores.mean()


__all__ = ["binned_sum", "hard_anatomy_dice", "matched_grid_grad",
           "matched_grid_grad_plain", "matched_warp", "matched_warp_fused",
           "matched_warp_fused_plain", "matched_warp_plain"]
