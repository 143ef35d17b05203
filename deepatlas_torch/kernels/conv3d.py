"""3-D convolutions on channel-last tensors: the k3 conv, its weight
gradient, and the 1x1x1 conv.

``conv3d_k3`` replaces the TPU kernel
``deepatlas_tpu/pallas/conv3d.py::_conv_fwd_kernel`` (``packed_conv3d``
with a k3 kernel); ``conv3d_k3_wgrad`` replaces ``_conv_wgrad_kernel``;
``conv3d_point`` replaces ``_conv_point_kernel`` (``packed_conv3d`` with a
1x1x1 kernel).  All run on plain contiguous ``(B, D, H, W, C)`` tensors with
any channel count: the TPU kernels' packed ``(D, H, W*C)`` lane layout,
banded weight banks, power-of-two channel rule and pad masks exist only for
Mosaic's 128-lane tiles and are not ported.

Bounds on an H100: the k3 conv and its weight gradient do ``2*27*Cin*Cout``
flops per voxel against ``2*(Cin+Cout)`` bytes in bf16, far above the card's
~295 flops/byte balance point, so they are bound by operations; the 1x1x1
conv (16 -> n_classes on the U-Net head) is bound by bytes.  The CUDA
designs and what they do about each bound are described in
``csrc/conv3d.cu``, ``csrc/conv3d_wgrad.cu`` and ``csrc/channel_mix.cuh``.

Each wrapper dispatches on the input's device only: a CPU tensor goes to the
plain PyTorch version beside it, a CUDA tensor to the CUDA kernel (or the
wrapper raises).  ``<wrapper>.launches`` counts kernel launches.

Gradients: ``conv3d_k3`` and ``conv3d_point`` are ``torch.autograd.Function``s
whose backward follows the JAX package's ``custom_vjp``s.  For the k3 conv
``dx`` is the same forward kernel on the upstream gradient with the flipped,
transposed weights, ``dW`` is ``conv3d_k3_wgrad``; for the 1x1x1 conv ``dx``
is the same kernel with the transposed weights and ``dW`` a plain matrix
product (as in the JAX package, which leaves it to XLA).  The backward runs
through the same device dispatch, so on the CPU it reaches the plain
versions.

Stride: ``conv3d_k3`` and ``conv3d_k3_wgrad`` take ``stride`` 1 or 2.
Conv3d(k3 s2 p1) is the stride-1 conv subsampled at the even indices (output
``o`` reads inputs ``2o-1..2o+1``; ``ceil(n / 2)`` outputs per axis); the
kernels compute only those outputs, the plain versions compute them all and
subsample (forward) or put the upstream gradient at the even positions of a
zero tensor (weight gradient).  The strided conv's ``dx`` is the stride-1
kernel on that zero-stuffed gradient.

Types: x float32 or bfloat16; weights are rounded to x's type (as the JAX
modules cast their float32 parameters to the compute type), products
accumulate in float32, and the output is rounded to x's type once.  The
upstream gradient is rounded to x's type first; ``dx`` comes back in x's
type, ``dW`` and ``db`` in float32, and the weight's rounding passes the
gradient straight through.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "conv3d_k3": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "conv3d_point": [_I, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
}
_WGRAD_SIGNATURES = {
    "conv3d_k3_wgrad_chunks": [_I, _I, _I, _I, _I, _I, _I],
    "conv3d_k3_wgrad": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}


def check_operands(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], w_lead: tuple,
                   what: str) -> None:
    """Validate a conv's operands: x ``(B, D, H, W, Cin)`` contiguous
    float32/bfloat16, w ``w_lead + (Cin, Cout)``, bias ``(Cout,)``, all on
    one device."""
    if x.dim() != 5:
        raise ValueError(f"{what}: x must be (B, D, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if tuple(w.shape[:-2]) != w_lead or w.shape[-2] != x.shape[-1]:
        raise ValueError(f"{what}: w must be {w_lead + (x.shape[-1], 'Cout')}"
                         f", got {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[-1],):
        raise ValueError(f"{what}: bias must be ({w.shape[-1]},), got "
                         f"{tuple(bias.shape)}")
    for t in (w, bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: operands on {x.device} and {t.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def kernel_operands(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor]):
    """Weights rounded to x's type and widened back to float32 (the kernels
    read float32 weights), and a float32 bias (or None)."""
    wk = w.detach().to(x.dtype).float().contiguous()
    bk = None if bias is None else bias.detach().float().contiguous()
    return wk, bk


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def upstream(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The upstream gradient as the kernels take it: in x's type and
    contiguous (autograd hands a conv below a ``torch.cat`` a channel slice
    of a wider tensor)."""
    return g.to(x.dtype).contiguous()


def strided_shape(dhw, stride: int) -> tuple:
    """Output sizes of a k3 p1 conv of ``stride``: ``ceil(n / stride)``."""
    return tuple(-(-int(n) // stride) for n in dhw)


def _check_stride(stride: int, what: str) -> None:
    if stride not in (1, 2):
        raise ValueError(f"{what}: stride must be 1 or 2, got {stride}")


def zero_stuffed(g: torch.Tensor, dhw, stride: int) -> torch.Tensor:
    """``g`` at every ``stride``-th voxel of a zero ``(B, *dhw, C)`` tensor:
    the upstream gradient of a strided conv as its stride-1 twin sees it."""
    if stride == 1:
        return g
    full = g.new_zeros((g.shape[0], *dhw, g.shape[-1]))
    full[:, ::stride, ::stride, ::stride] = g
    return full


def bias_grad(g: torch.Tensor) -> torch.Tensor:
    """Gradient of a fused bias: g summed over the voxels, in float32."""
    return g.sum(dim=(0, 1, 2, 3), dtype=torch.float32)


# -------------------------------------------------------------- k3 conv

def _k3_math(x, wk, bk, stride=1):
    """Conv3d k3 p1 as 27 shifted channel contractions (no cuDNN), on
    weights already rounded by ``kernel_operands``; a strided conv is the
    stride-1 result at the even voxels."""
    b, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.zeros(b, d, h, wd, wk.shape[-1], dtype=torch.float32,
                      device=x.device)
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                out += torch.einsum(
                    "bdhwi,io->bdhwo",
                    xp[:, kz:kz + d, ky:ky + h, kx:kx + wd], wk[kz, ky, kx])
    if bk is not None:
        out += bk
    if stride != 1:
        out = out[:, ::stride, ::stride, ::stride].contiguous()
    return out.to(x.dtype)


def _k3_cuda(x, wk, bk, stride=1):
    b, d, h, wd, cin = x.shape
    cout = wk.shape[-1]
    y = torch.empty(b, *strided_shape((d, h, wd), stride), cout,
                    dtype=x.dtype, device=x.device)
    lib = build.load("conv3d", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
                           _ptr(bk), y.data_ptr(), b, d, h, wd, cin, cout,
                           stride, stream)
    build.check(rc, "conv3d_k3")
    conv3d_k3.launches += 1
    return y


def _k3_op(x, wk, bk, stride=1):
    return _k3_math(x, wk, bk, stride) if x.device.type == "cpu" \
        else _k3_cuda(x, wk, bk, stride)


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    stride: int = 1) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_k3`` (forward only)."""
    _check_stride(stride, "conv3d_k3")
    return _k3_math(x, *kernel_operands(x, w, bias), stride)


def adjoint_k3_weights(wk: torch.Tensor) -> torch.Tensor:
    """``w_t[kz, ky, kx, co, ci] = w[2-kz, 2-ky, 2-kx, ci, co]``: the k3
    conv with these weights is the adjoint of the conv with ``w``."""
    return wk.flip(0, 1, 2).transpose(3, 4).contiguous()


class _ConvK3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride):
        wk, bk = kernel_operands(x, w, bias)
        ctx.save_for_backward(x, wk)
        ctx.has_bias = bias is not None
        ctx.stride = stride
        return _k3_op(x, wk, bk, stride)

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        g = upstream(g, x)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _k3_op(zero_stuffed(g, x.shape[1:4], ctx.stride),
                        adjoint_k3_weights(wk), None)
        if ctx.needs_input_grad[1]:
            dw = conv3d_k3_wgrad(x, g, ctx.stride)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = bias_grad(g)
        return dx, dw, db, None


def conv3d_k3(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              stride: int = 1) -> torch.Tensor:
    """Conv3d kernel 3, stride 1 or 2, zero padding 1; differentiable in x,
    w and bias.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(3, 3, 3, Cin, Cout)`` (flax's DHWIO layout).
      bias: optional ``(Cout,)``, added in float32 before the output is
        rounded.
      stride: 1, or 2 for ``ceil(n / 2)`` outputs per axis.

    Returns ``(B, D', H', W', Cout)`` in x's type.
    """
    check_operands(x, w, bias, (3, 3, 3), "conv3d_k3")
    _check_stride(stride, "conv3d_k3")
    return _ConvK3.apply(x, w, bias, stride)


conv3d_k3.launches = 0


# ------------------------------------------------- k3 weight gradient

def _wgrad_math(x, g, stride=1):
    b, d, h, wd, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = zero_stuffed(g, (d, h, wd), stride).float()
    dw = torch.empty(3, 3, 3, cin, g.shape[-1], dtype=torch.float32,
                     device=x.device)
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                dw[kz, ky, kx] = torch.einsum(
                    "bdhwi,bdhwo->io",
                    xp[:, kz:kz + d, ky:ky + h, kx:kx + wd], gf)
    return dw


def _wgrad_cuda(x, g, stride=1):
    b, d, h, wd, cin = x.shape
    cout = g.shape[-1]
    lib = build.load("conv3d_wgrad", _WGRAD_SIGNATURES)
    chunks = lib.conv3d_k3_wgrad_chunks(b, d, h, wd, cin, cout, stride)
    partial = torch.empty(chunks, 27, cin, cout, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(3, 3, 3, cin, cout, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_wgrad(_DTYPES[x.dtype], x.data_ptr(),
                                 g.data_ptr(), partial.data_ptr(),
                                 dw.data_ptr(), b, d, h, wd, cin, cout,
                                 stride, stream)
    build.check(rc, "conv3d_k3_wgrad")
    conv3d_k3_wgrad.launches += 1
    return dw


def _check_wgrad_operands(x: torch.Tensor, g: torch.Tensor,
                          stride: int = 1) -> None:
    what = "conv3d_k3_wgrad"
    _check_stride(stride, what)
    if x.dim() != 5 or g.dim() != 5 or g.shape[0] != x.shape[0] \
            or tuple(g.shape[1:4]) != strided_shape(x.shape[1:4], stride):
        raise ValueError(f"{what}: x (B, D, H, W, Cin) and g (B, D, H, W, "
                         f"Cout) must share their voxels (ceil(n / stride) "
                         f"of them at stride {stride}), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"{what}: x and g must share float32 or bfloat16, "
                        f"got {x.dtype} and {g.dtype}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{what}: x and g must be contiguous")
    if g.device != x.device:
        raise ValueError(f"{what}: operands on {x.device} and {g.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def conv3d_k3_wgrad_plain(x: torch.Tensor, g: torch.Tensor,
                          stride: int = 1) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_k3_wgrad``: 27 shifted
    contractions over the voxels of the zero-padded x, in float32 (a
    strided g is first put at the even voxels of a zero tensor)."""
    _check_wgrad_operands(x, g, stride)
    return _wgrad_math(x, g, stride)


def conv3d_k3_wgrad(x: torch.Tensor, g: torch.Tensor,
                    stride: int = 1) -> torch.Tensor:
    """Weight gradient of ``conv3d_k3``::

        dW[kz, ky, kx, ci, co] = sum_{b,d,h,w} x[b, s d+kz-1, s h+ky-1,
                                                 s w+kx-1, ci] * g[b, d, h, w, co]

    with ``s`` the stride and out-of-volume x read as zero.

    Args:
      x: the conv's input ``(B, D, H, W, Cin)``, float32 or bfloat16,
        contiguous.
      g: the gradient of the conv's output ``(B, D', H', W', Cout)`` in
        x's type, contiguous (``ceil(n / stride)`` voxels per axis).
      stride: the conv's stride, 1 or 2.

    Returns ``(3, 3, 3, Cin, Cout)`` float32 (products accumulated in
    float32).  The CUDA kernel sums in a fixed order, so the result is the
    same from run to run.
    """
    _check_wgrad_operands(x, g, stride)
    if x.device.type == "cpu":
        return _wgrad_math(x, g, stride)
    return _wgrad_cuda(x, g, stride)


conv3d_k3_wgrad.launches = 0


# ------------------------------------------------------------ 1x1x1 conv

def _point_weight(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape[-2:]) if w.dim() == 5 else w


def _point_math(x, wk, bk):
    out = torch.einsum("bdhwi,io->bdhwo", x.float(), wk)
    if bk is not None:
        out += bk
    return out.to(x.dtype)


def _point_cuda(x, wk, bk):
    cout = wk.shape[-1]
    y = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype, device=x.device)
    lib = build.load("conv3d", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_point(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
                              _ptr(bk), y.data_ptr(), x.numel() // x.shape[-1],
                              x.shape[-1], cout, stream)
    build.check(rc, "conv3d_point")
    conv3d_point.launches += 1
    return y


def _point_op(x, wk, bk):
    return _point_math(x, wk, bk) if x.device.type == "cpu" \
        else _point_cuda(x, wk, bk)


def conv3d_point_plain(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_point`` (forward only): one
    channel contraction (no cuDNN)."""
    return _point_math(x, *kernel_operands(x, _point_weight(w), bias))


def voxel_product(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``x^T g`` over the voxels: ``(Cin, N)`` float32 from x ``(..., Cin)``
    and g ``(..., N)``.  A plain matrix product (the JAX package leaves the
    same one to XLA); the operands are widened first so that the sum is
    kept in float32 whatever their type."""
    return x.reshape(-1, x.shape[-1]).float().t() @ \
        g.reshape(-1, g.shape[-1]).float()


class _ConvPoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        wk, bk = kernel_operands(x, w, bias)
        ctx.save_for_backward(x, wk)
        ctx.has_bias = bias is not None
        return _point_op(x, wk, bk)

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        g = upstream(g, x)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _point_op(g, wk.t().contiguous(), None)
        if ctx.needs_input_grad[1]:
            dw = voxel_product(x, g)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = bias_grad(g)
        return dx, dw, db


def conv3d_point(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1x1 conv (per-voxel channel mix); differentiable in x, w and bias.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(Cin, Cout)`` or ``(1, 1, 1, Cin, Cout)``.
      bias: optional ``(Cout,)``.

    Returns ``(B, D, H, W, Cout)`` in x's type.
    """
    if w.dim() == 5 and tuple(w.shape[:3]) != (1, 1, 1):
        raise ValueError(f"conv3d_point: w must be (1, 1, 1, Cin, Cout) or "
                         f"(Cin, Cout), got {tuple(w.shape)}")
    check_operands(x, _point_weight(w), bias, (), "conv3d_point")
    return _ConvPoint.apply(x, _point_weight(w), bias)


conv3d_point.launches = 0
