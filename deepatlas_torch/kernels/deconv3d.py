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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .conv3d import _DTYPES, _ptr, check_operands, kernel_operands

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "deconv2x": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def deconv2x_plain(x: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k2 s2 transposed conv as one contraction over the 8 taps, then an
    interleave of the taps into the doubled grid (no cuDNN)."""
    b, d, h, wd, _ = x.shape
    wk, bk = kernel_operands(x, w, bias)
    y = torch.einsum("bdhwi,apqio->bdahpwqo", x.float(), wk)
    y = y.reshape(b, 2 * d, 2 * h, 2 * wd, w.shape[-1])
    if bk is not None:
        y += bk
    return y.to(x.dtype)


def deconv2x(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ConvTranspose3d(kernel 2, stride 2) on channel-last tensors.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(2, 2, 2, Cin, Cout)``.
      bias: optional ``(Cout,)``.

    Returns ``(B, 2D, 2H, 2W, Cout)`` in x's type.
    """
    check_operands(x, w, bias, (2, 2, 2), "deconv2x")
    if x.device.type == "cpu":
        return deconv2x_plain(x, w, bias)
    wk, bk = kernel_operands(x, w, bias)
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
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


deconv2x.launches = 0
