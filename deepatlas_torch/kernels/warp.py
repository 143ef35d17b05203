"""Trilinear warp on channel-last tensors: the forward gather, its gradient
with respect to the sample grid, and its adjoint in the values (the splat).

``warp_trilinear`` replaces the TPU kernel
``deepatlas_tpu/pallas/warp.py::_fwd_kernel``, ``warp_grid_grad`` replaces
``::_bwd_grid_kernel`` and ``splat_trilinear`` replaces
``deepatlas_tpu/pallas/splat.py::_splat_kernel``; ``grid_sample`` is the
counterpart of ``pallas_grid_sample``, the differentiable entry point.  The
TPU kernels rebuild the gather from lane shifts over a staged slab, which is
where their displacement bound, depth limit and dense fallbacks come from; a
CUDA thread gathers its 8 corners directly, so these kernels have no limit of
their own and ``max_disp`` survives only as the bound of the clamp.

Semantics (``F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True)``): the grid's last axis is ``(x, y, z)`` = (W, H, D) in
normalized [-1, 1] units, un-normalized in float32 as
``(g + 1) * ((n - 1) / 2)``; the 8 corners around ``floor`` of that point are
blended with float32 weights; a corner outside the volume contributes zero.
Values are float32 or bfloat16, sums are kept in float32 and rounded once.

Bounds on an H100: all three move a few bytes per flop and are bound by
bytes (``csrc/warp.cu`` says what the design does about it).

Each wrapper dispatches on its input's device only: a CPU tensor goes to the
plain PyTorch version beside it, a CUDA tensor to the CUDA kernel (or the
wrapper raises).  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..ops.warp import clamp_displacement, unnormalize
from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_DIMS = [_I] * 8
_SIGNATURES = {
    "warp_trilinear": [_I, _P, _P, _P, *_DIMS, _P],
    "warp_grid_grad": [_I, _P, _P, _P, _P, *_DIMS, _P],
    "splat_trilinear": [_I, _P, _P, _P, _P, _P, *_DIMS, _P],
}


def _check(what: str, values: torch.Tensor, grid: torch.Tensor,
           at_grid: bool) -> None:
    """``values`` is ``(B, D, H, W, C)`` (the volume) or, with ``at_grid``,
    ``(B, Do, Ho, Wo, C)`` (sampled at the grid's points)."""
    if values.dim() != 5 or grid.dim() != 5 or grid.shape[-1] != 3 \
            or grid.shape[0] != values.shape[0]:
        raise ValueError(f"{what}: expected (B, D, H, W, C) values and a "
                         f"(B, Do, Ho, Wo, 3) grid, got "
                         f"{tuple(values.shape)} and {tuple(grid.shape)}")
    if at_grid and values.shape[1:4] != grid.shape[1:4]:
        raise ValueError(f"{what}: values {tuple(values.shape)} do not sit "
                         f"at the grid's points {tuple(grid.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"{what}: values must be float32 or bfloat16, got "
                        f"{values.dtype}")
    if grid.dtype != torch.float32:
        raise TypeError(f"{what}: the grid must be float32, got {grid.dtype}")
    if not (values.is_contiguous() and grid.is_contiguous()):
        raise ValueError(f"{what}: values and grid must be contiguous")
    if grid.device != values.device:
        raise ValueError(f"{what}: operands on {values.device} and "
                         f"{grid.device}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {values.device}")


def _dims(b, dhw, c, grid):
    return (b, *dhw, c, *grid.shape[1:4])


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------- plain versions

def _corners(grid: torch.Tensor, d: int, h: int, w: int):
    """The 8 corners of every sample point: yields ``(index, weight)``, both
    ``(B * P,)``: the corner's flat voxel index in the ``(B * D * H * W)``
    batch of volumes (clamped into the volume) and its float32 weight,
    zeroed where the corner lies outside.  Differentiable in the grid
    through the weights."""
    b = grid.shape[0]
    gx = unnormalize(grid[..., 0], w).reshape(b, -1)
    gy = unnormalize(grid[..., 1], h).reshape(b, -1)
    gz = unnormalize(grid[..., 2], d).reshape(b, -1)
    x0, y0, z0 = gx.floor(), gy.floor(), gz.floor()
    fx, fy, fz = gx - x0, gy - y0, gz - z0
    base = torch.arange(b, device=grid.device)[:, None] * (d * h * w)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = x0 + dx, y0 + dy, z0 + dz
                inb = ((ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
                       & (iz >= 0) & (iz <= d - 1))
                weight = ((fz if dz else 1 - fz) * (fy if dy else 1 - fy)
                          * (fx if dx else 1 - fx))
                idx = ((iz.clamp(0, d - 1).long() * h
                        + iy.clamp(0, h - 1).long()) * w
                       + ix.clamp(0, w - 1).long()) + base
                yield idx.reshape(-1), torch.where(
                    inb, weight, torch.zeros_like(weight)).reshape(-1)


def _warp_math(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    b, d, h, w, c = vol.shape
    flat = vol.reshape(b * d * h * w, c).float()
    out = None
    for idx, weight in _corners(grid, d, h, w):
        term = flat.index_select(0, idx) * weight[:, None]
        out = term if out is None else out + term
    return out.reshape(*grid.shape[:4], c).to(vol.dtype)


def _splat_math(ct: torch.Tensor, grid: torch.Tensor,
                dhw: Sequence[int]) -> torch.Tensor:
    b, c = ct.shape[0], ct.shape[-1]
    d, h, w = dhw
    flat = ct.reshape(-1, c).float()
    out = torch.zeros(b * d * h * w, c, dtype=torch.float32,
                      device=ct.device)
    for idx, weight in _corners(grid, d, h, w):
        out.index_add_(0, idx, flat * weight[:, None])
    return out.reshape(b, d, h, w, c)


def _grid_grad_math(vol: torch.Tensor, grid: torch.Tensor,
                    ct: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        g = grid.detach().requires_grad_(True)
        out = _warp_math(vol.detach(), g)
        (dgrid,) = torch.autograd.grad(out, g, ct.to(out.dtype))
    return dgrid


def warp_trilinear_plain(vol: torch.Tensor, grid: torch.Tensor
                         ) -> torch.Tensor:
    """The plain PyTorch version of ``warp_trilinear``: 8 gathers
    (``index_select``) blended with the corner weights.  Differentiable;
    its autograd is the plain version of the other two kernels."""
    _check("warp_trilinear", vol, grid, at_grid=False)
    return _warp_math(vol, grid)


def warp_grid_grad_plain(vol: torch.Tensor, grid: torch.Tensor,
                         ct: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``warp_grid_grad``: autograd of
    ``warp_trilinear_plain`` with respect to the grid."""
    _check("warp_grid_grad", vol, grid, at_grid=False)
    _check("warp_grid_grad", ct, grid, at_grid=True)
    return _grid_grad_math(vol, grid, ct)


def splat_trilinear_plain(ct: torch.Tensor, grid: torch.Tensor,
                          dhw: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version of ``splat_trilinear``: 8 ``index_add_``
    scatters, float32."""
    _check("splat_trilinear", ct, grid, at_grid=True)
    return _splat_math(ct, grid, tuple(int(n) for n in dhw))


# ------------------------------------------------------------- kernels

def _warp_cuda(vol, grid):
    b, d, h, w, c = vol.shape
    out = torch.empty(*grid.shape[:4], c, dtype=vol.dtype, device=vol.device)
    lib = build.load("warp", _SIGNATURES)
    with torch.cuda.device(vol.device):
        rc = lib.warp_trilinear(_DTYPES[vol.dtype], vol.data_ptr(),
                                grid.data_ptr(), out.data_ptr(),
                                *_dims(b, (d, h, w), c, grid), _stream(vol))
    build.check(rc, "warp_trilinear")
    warp_trilinear.launches += 1
    return out


def _grid_grad_cuda(vol, grid, ct):
    b, d, h, w, c = vol.shape
    dgrid = torch.empty_like(grid)
    lib = build.load("warp", _SIGNATURES)
    with torch.cuda.device(vol.device):
        rc = lib.warp_grid_grad(_DTYPES[vol.dtype], vol.data_ptr(),
                                grid.data_ptr(), ct.data_ptr(),
                                dgrid.data_ptr(),
                                *_dims(b, (d, h, w), c, grid), _stream(vol))
    build.check(rc, "warp_grid_grad")
    warp_grid_grad.launches += 1
    return dgrid


def _splat_cuda(ct, grid, dhw):
    b, c = ct.shape[0], ct.shape[-1]
    dvol = torch.empty(b, *dhw, c, dtype=torch.float32, device=ct.device)
    # the kernel's scratch: the fixed-point sums and each channel's max |ct|
    acc = torch.zeros(b, *dhw, c, dtype=torch.int64, device=ct.device)
    maxbits = torch.zeros(c, dtype=torch.int32, device=ct.device)
    lib = build.load("warp", _SIGNATURES)
    with torch.cuda.device(ct.device):
        rc = lib.splat_trilinear(_DTYPES[ct.dtype], ct.data_ptr(),
                                 grid.data_ptr(), dvol.data_ptr(),
                                 acc.data_ptr(), maxbits.data_ptr(),
                                 *_dims(b, dhw, c, grid), _stream(ct))
    build.check(rc, "splat_trilinear")
    splat_trilinear.launches += 1
    return dvol


def warp_trilinear(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of ``vol`` at ``grid`` (forward only, no clamp)::

        out[b, p, c] = sum over the 8 corners k of p:  w_k vol[b, corner_k, c]

    Args:
      vol: ``(B, D, H, W, C)`` float32 or bfloat16, contiguous.
      grid: ``(B, Do, Ho, Wo, 3)`` float32 normalized ``(x, y, z)``.

    Returns ``(B, Do, Ho, Wo, C)`` in vol's type.
    """
    _check("warp_trilinear", vol, grid, at_grid=False)
    if vol.device.type == "cpu":
        return _warp_math(vol, grid)
    return _warp_cuda(vol, grid)


warp_trilinear.launches = 0


def warp_grid_grad(vol: torch.Tensor, grid: torch.Tensor,
                   ct: torch.Tensor) -> torch.Tensor:
    """Gradient of ``sum(warp_trilinear(vol, grid) * ct)`` with respect to
    ``grid``, summed over the channels, in the grid's normalized units
    (the voxel-coordinate derivative times ``(n - 1) / 2`` per axis, order
    x, y, z).

    The derivative is that of the corner weights at fixed corners (the
    floor rule, which is also what autograd of the plain version gives): at
    an exactly integral coordinate it is the one-sided derivative towards
    the upper corner, where the TPU kernel's tent form returns 0.  A corner
    outside the volume contributes nothing.

    Args:
      vol: ``(B, D, H, W, C)``; ct: ``(B, Do, Ho, Wo, C)`` in vol's type.

    Returns ``(B, Do, Ho, Wo, 3)`` float32.
    """
    _check("warp_grid_grad", vol, grid, at_grid=False)
    _check("warp_grid_grad", ct, grid, at_grid=True)
    if ct.dtype != vol.dtype or ct.device != vol.device \
            or ct.shape[-1] != vol.shape[-1]:
        raise ValueError(f"warp_grid_grad: ct {tuple(ct.shape)} {ct.dtype} "
                         f"on {ct.device} does not match vol "
                         f"{tuple(vol.shape)} {vol.dtype} on {vol.device}")
    if vol.device.type == "cpu":
        return _grid_grad_math(vol, grid, ct)
    return _grid_grad_cuda(vol, grid, ct)


warp_grid_grad.launches = 0


def splat_trilinear(ct: torch.Tensor, grid: torch.Tensor,
                    dhw: Sequence[int]) -> torch.Tensor:
    """The adjoint of ``warp_trilinear`` in the values: scatter-add every
    ``ct[b, p, c]`` to the 8 corners of ``p`` with the corner weights::

        dvol[b, corner_k, c] += w_k ct[b, p, c]

    On the card the sums are kept in 64-bit fixed point, so the result is
    the same bit for bit from run to run: each channel gets a power-of-two
    scale ``2^e`` with ``P * max|ct| * 2^e <= 2^62`` (``P`` the points of
    one sample; a first pass takes the max), every term ``w_k * ct`` (the
    float32 product, as the plain version rounds it) is scaled and rounded
    to an integer, the integers are added with 64-bit atomics in any order,
    and each sum is rounded once to float32 and scaled back.  That is within
    ``2^-e`` a term of the exact sum, far inside float32's rounding.  A
    channel whose ``ct`` holds a NaN or an infinity is NaN everywhere in the
    output (the plain version is NaN at least where such a value lands).
    ``ct`` values that are exactly 0 add nothing, so a one-hot ``ct`` costs
    about what one channel costs.  One call runs the max, the scatter and
    the conversion, and counts one launch in ``splat_trilinear.launches``;
    it holds an int64 scratch of the output's shape while it runs.

    Args:
      ct: ``(B, Do, Ho, Wo, C)`` float32 or bfloat16, contiguous.
      dhw: the volume's ``(D, H, W)``.

    Returns ``(B, D, H, W, C)`` float32 (the caller casts it).
    """
    _check("splat_trilinear", ct, grid, at_grid=True)
    dhw = tuple(int(n) for n in dhw)
    if ct.device.type == "cpu":
        return _splat_math(ct, grid, dhw)
    return _splat_cuda(ct, grid, dhw)


splat_trilinear.launches = 0


# ------------------------------------------------- differentiable entry

class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, grid, grid_grad):
        ctx.save_for_backward(vol, grid)
        ctx.grid_grad = grid_grad
        return warp_trilinear(vol, grid)

    @staticmethod
    def backward(ctx, ct):
        vol, grid = ctx.saved_tensors
        ct = ct.to(vol.dtype).contiguous()
        dvol = dgrid = None
        if ctx.needs_input_grad[0]:
            dvol = splat_trilinear(ct, grid, vol.shape[1:4]).to(vol.dtype)
        if ctx.needs_input_grad[1] and ctx.grid_grad:
            dgrid = warp_grid_grad(vol, grid, ct)
        return dvol, dgrid, None


def grid_sample(vol: torch.Tensor, grid: torch.Tensor, *,
                max_disp: Optional[int] = 8, grad: str = "full"
                ) -> torch.Tensor:
    """Differentiable trilinear ``grid_sample`` (align_corners=True, zero
    padding) on the warp kernels.

    Args:
      vol: ``(B, D, H, W, C)`` float32 or bfloat16.
      grid: ``(B, Do, Ho, Wo, 3)`` normalized sample grid, last axis
        ``(x, y, z)``.
      max_disp: each axis of ``grid - identity`` is clamped to
        +-``max_disp`` voxels before sampling (in float32, in normalized
        units; the grid then has the volume's shape), so an oversized field
        saturates and gets no gradient past the bound.  ``None`` samples
        the grid as it is.
      grad: ``"full"`` differentiates with respect to the volume and the
        grid; ``"values"`` skips the grid-gradient kernel and returns no
        grid gradient, for callers whose grid is a constant.

    The backward launches ``warp_grid_grad`` for the grid and
    ``splat_trilinear`` for the volume, each only when that input requires
    a gradient.  Returns ``(B, Do, Ho, Wo, C)`` in vol's type.
    """
    if grad not in ("full", "values"):
        raise ValueError(f"grad must be 'full' or 'values', got {grad!r}")
    if vol.dim() != 5 or grid.dim() != 5 or grid.shape[-1] != 3:
        raise ValueError(f"expected vol (B,D,H,W,C), grid (B,D,H,W,3); got "
                         f"{tuple(vol.shape)}, {tuple(grid.shape)}")
    if max_disp is not None:
        if grid.shape[1:4] != vol.shape[1:4]:
            raise ValueError(
                f"the displacement clamp needs a grid of the volume's shape"
                f", got {tuple(grid.shape)} for {tuple(vol.shape)}")
        grid = clamp_displacement(grid, max_disp)
    return _GridSample.apply(vol.contiguous(), grid.float().contiguous(),
                             grad == "full")


__all__ = ["grid_sample", "splat_trilinear", "splat_trilinear_plain",
           "warp_grid_grad", "warp_grid_grad_plain", "warp_trilinear",
           "warp_trilinear_plain"]
