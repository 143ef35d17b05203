"""ConvTranspose3d kernel 2, stride 2 (the U-Net upsampler).

``deconv2x`` replaces the TPU kernel
``deepatlas_tpu/pallas/deconv3d.py::_deconv_kernel`` (``packed_deconv2x``).
Kernel == stride, so there is no output overlap::

    y[b, 2d+a, 2h+p, 2w+q, :] = x[b, d, h, w, :] @ w[a, p, q]

with ``w`` in the packed ``(2, 2, 2, Cin, Cout)`` (I, O) layout.  Bound by
bytes on an H100: 16*Cin*Cout flops per input voxel against the 8*Cout
output values it writes.  The CUDA design is described in
``csrc/deconv3d.cu`` and ``csrc/channel_mix.cuh``.

The wrapper dispatches on the input's device only (CPU: the plain version;
CUDA: the kernel, or it raises); ``deconv2x.launches`` counts launches.
Types as in ``kernels/conv3d.py``.

Gradient: ``deconv2x`` is a ``torch.autograd.Function``.  Its backward
regroups the upstream gradient to ``(voxels, 8*Cout)``, one row per input
voxel, and takes ``dx`` and ``dW`` as two plain matrix products -- as the
JAX package does (``packed_deconv2x``'s ``op_bwd`` is two XLA
``dot_general``s, no Pallas kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .conv3d import (_DTYPES, _ptr, bias_grad, check_operands,
                     kernel_operands, upstream, voxel_product)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "deconv2x": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _deconv_math(x, wk, bk):
    """k2 s2 transposed conv as one contraction over the 8 taps, then an
    interleave of the taps into the doubled grid (no cuDNN), on weights
    already rounded by ``kernel_operands``."""
    b, d, h, wd, _ = x.shape
    y = torch.einsum("bdhwi,apqio->bdahpwqo", x.float(), wk)
    y = y.reshape(b, 2 * d, 2 * h, 2 * wd, wk.shape[-1])
    if bk is not None:
        y += bk
    return y.to(x.dtype)


def _deconv_cuda(x, wk, bk):
    b, d, h, wd, cin = x.shape
    cout = wk.shape[-1]
    y = torch.empty(b, 2 * d, 2 * h, 2 * wd, cout, dtype=x.dtype,
                    device=x.device)
    lib = build.load("deconv3d", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deconv2x(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
                          _ptr(bk), y.data_ptr(), b, d, h, wd, cin, cout,
                          stream)
    build.check(rc, "deconv2x")
    deconv2x.launches += 1
    return y


def _deconv_op(x, wk, bk):
    return _deconv_math(x, wk, bk) if x.device.type == "cpu" \
        else _deconv_cuda(x, wk, bk)


def deconv2x_plain(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of ``deconv2x`` (forward only)."""
    return _deconv_math(x, *kernel_operands(x, w, bias))


class _Deconv2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        wk, bk = kernel_operands(x, w, bias)
        ctx.save_for_backward(x, wk)
        ctx.has_bias = bias is not None
        return _deconv_op(x, wk, bk)

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        g = upstream(g, x)
        b, d, h, wd, cin = x.shape
        cout = wk.shape[-1]
        # (B, 2D, 2H, 2W, Co) -> one row of the 8 taps per input voxel
        go = g.view(b, d, 2, h, 2, wd, 2, cout).permute(
            0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, 8 * cout)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w2 = wk.permute(3, 0, 1, 2, 4).reshape(cin, 8 * cout)
            dx = (go @ w2.to(x.dtype).t()).view(x.shape)
        if ctx.needs_input_grad[1]:
            dw = voxel_product(x, go).view(cin, 2, 2, 2, cout).permute(
                1, 2, 3, 0, 4).contiguous()
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = bias_grad(g)
        return dx, dw, db


def deconv2x(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ConvTranspose3d(kernel 2, stride 2) on channel-last tensors;
    differentiable in x, w and bias.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(2, 2, 2, Cin, Cout)``.
      bias: optional ``(Cout,)``.

    Returns ``(B, 2D, 2H, 2W, Cout)`` in x's type.
    """
    check_operands(x, w, bias, (2, 2, 2), "deconv2x")
    return _Deconv2x.apply(x, w, bias)


deconv2x.launches = 0


def nearest_up2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of ``(B, D, H, W, C)`` as ``deconv2x``
    with the constant identity bank: every tap copies its input voxel, so
    the result equals ``ops.nearest_resize`` to twice the size bit for bit.
    Counterpart of the JAX package's ``packed_nearest_up2``, which runs the
    VoxelMorph decoder's full-resolution upsample on the same TPU kernel;
    the bank is a constant, so the backward takes ``dx`` only."""
    c = x.shape[-1]
    bank = torch.eye(c, device=x.device).expand(2, 2, 2, c, c)
    return deconv2x(x, bank)
