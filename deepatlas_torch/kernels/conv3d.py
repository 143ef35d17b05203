"""3-D convolutions on channel-last tensors: the k3 conv and the 1x1x1 conv.

``conv3d_k3`` replaces the TPU kernel
``deepatlas_tpu/pallas/conv3d.py::_conv_fwd_kernel`` (``packed_conv3d``
with a k3 kernel); ``conv3d_point`` replaces ``_conv_point_kernel``
(``packed_conv3d`` with a 1x1x1 kernel).  Both run on plain contiguous
``(B, D, H, W, C)`` tensors with any channel count: the TPU kernels' packed
``(D, H, W*C)`` lane layout, banded weight banks, power-of-two channel rule
and pad masks exist only for Mosaic's 128-lane tiles and are not ported.

Bounds on an H100: the k3 conv does ``2*27*Cin*Cout`` flops per voxel
against ``2*(Cin+Cout)`` bytes in bf16, far above the card's ~295
flops/byte balance point, so it is bound by operations; the 1x1x1 conv
(16 -> 5 on the U-Net head) is bound by bytes.  The CUDA design and what
it does about each bound is described in ``csrc/conv3d.cu`` and
``csrc/channel_mix.cuh``.

Each wrapper dispatches on the input's device only: a CPU tensor goes to the
plain PyTorch version beside it, a CUDA tensor to the CUDA kernel (or the
wrapper raises).  ``<wrapper>.launches`` counts kernel launches.

Types: x float32 or bfloat16; weights are rounded to x's type (as the JAX
modules cast their float32 parameters to the compute type), products
accumulate in float32, and the output is rounded to x's type once.
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
    "conv3d_k3": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "conv3d_point": [_I, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
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


# -------------------------------------------------------------- k3 conv

def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv3d k3 s1 p1 as 27 shifted channel contractions (no cuDNN)."""
    b, d, h, wd, _ = x.shape
    wk, bk = kernel_operands(x, w, bias)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    out = torch.zeros(b, d, h, wd, w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                out += torch.einsum(
                    "bdhwi,io->bdhwo",
                    xp[:, kz:kz + d, ky:ky + h, kx:kx + wd], wk[kz, ky, kx])
    if bk is not None:
        out += bk
    return out.to(x.dtype)


def conv3d_k3(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv3d kernel 3, stride 1, zero padding 1.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(3, 3, 3, Cin, Cout)`` (flax's DHWIO layout).
      bias: optional ``(Cout,)``, added in float32 before the output is
        rounded.

    Returns ``(B, D, H, W, Cout)`` in x's type.
    """
    check_operands(x, w, bias, (3, 3, 3), "conv3d_k3")
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, w, bias)
    wk, bk = kernel_operands(x, w, bias)
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty(b, d, h, wd, cout, dtype=x.dtype, device=x.device)
    lib = build.load("conv3d", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
                           _ptr(bk), y.data_ptr(), b, d, h, wd, cin, cout,
                           stream)
    build.check(rc, "conv3d_k3")
    conv3d_k3.launches += 1
    return y


conv3d_k3.launches = 0


# ------------------------------------------------------------ 1x1x1 conv

def _point_weight(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape[-2:]) if w.dim() == 5 else w


def conv3d_point_plain(x: torch.Tensor, w: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1x1 conv as one channel contraction (no cuDNN)."""
    wk, bk = kernel_operands(x, _point_weight(w), bias)
    out = torch.einsum("bdhwi,io->bdhwo", x.float(), wk)
    if bk is not None:
        out += bk
    return out.to(x.dtype)


def conv3d_point(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1x1 conv (per-voxel channel mix).

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(Cin, Cout)`` or ``(1, 1, 1, Cin, Cout)``.
      bias: optional ``(Cout,)``.

    Returns ``(B, D, H, W, Cout)`` in x's type.
    """
    if w.dim() == 5 and tuple(w.shape[:3]) != (1, 1, 1):
        raise ValueError(f"conv3d_point: w must be (1, 1, 1, Cin, Cout) or "
                         f"(Cin, Cout), got {tuple(w.shape)}")
    w = _point_weight(w)
    check_operands(x, w, bias, (), "conv3d_point")
    if x.device.type == "cpu":
        return conv3d_point_plain(x, w, bias)
    wk, bk = kernel_operands(x, w, bias)
    cout = w.shape[-1]
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


conv3d_point.launches = 0
