"""3-D convolutions on channel-last tensors: the k3 conv, its multi-plane
variant, its weight gradient, and the 1x1x1 conv.

``conv3d_k3`` replaces the TPU kernel
``deepatlas_tpu/pallas/conv3d.py::_conv_fwd_kernel`` (``packed_conv3d``
with a k3 kernel); ``conv3d_k3_block`` replaces ``_conv_fwd_block_kernel``
(``packed_conv3d_block``: the same conv, forward only, ``p_blk`` output
planes per step); ``conv3d_k3_wgrad`` replaces ``_conv_wgrad_kernel``;
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
``csrc/conv3d_mma.cu``, ``csrc/conv3d.cu``, ``csrc/conv3d_block.cu``,
``csrc/conv3d_wgrad.cu``, ``csrc/channel_mix_mma.cu`` and
``csrc/channel_mix.cuh``.

Each wrapper dispatches on the input's device, and on a CUDA tensor's type
too: a CPU tensor goes to the plain PyTorch version beside it; a bfloat16
CUDA tensor to the tensor-core kernels (``mma.sync``, as the TPU kernels
compute on the MXU in bf16 with float32 sums) of ``csrc/conv3d_mma.cu`` (the
k3 conv, its multi-plane variant and its weight gradient) and
``csrc/channel_mix_mma.cu`` (the 1x1x1 conv); a float32 CUDA tensor to the
CUDA-core kernels of ``csrc/conv3d.cu`` (the k3 conv; the 1x1x1 conv through
``csrc/channel_mix.cuh``), ``csrc/conv3d_block.cu`` and
``csrc/conv3d_wgrad.cu``.  A kernel that cannot launch raises: there is no
fallback.  ``<wrapper>.launches`` counts kernel launches.

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
zero tensor (weight gradient).  The strided conv's ``dx`` is, in the plain
version and on the float32 CUDA-core kernel, the stride-1 conv of that
zero-stuffed gradient; in bfloat16 on the card it is one launch over the 8
parity classes of the input voxels (``parity_tap_table``), which reads the
gradient as it is and does 1/8 of that work.

Depth padding: ``conv3d_k3``, ``conv3d_k3_input_grad`` and
``conv3d_k3_wgrad`` take ``pad_d``, 1 (the conv above) or 0, the conv of a
depth shard whose input carries one neighbour plane on each side (the
output of ``ops.halo.halo_exchange_d``): H and W stay padded by 1, output
plane ``o`` reads input planes ``s o .. s o + 2``, the output has ``D - 2``
planes at stride 1 and ``(D - 3) // 2 + 1`` at stride 2, ``dx`` covers every
input plane (the halo's too, whose gradients the exchange's adjoint sends
back) and ``dW`` sums over the halo'd input.  The kernels take the padding
as the depth origin of their halo gather, so no plane is computed to be
thrown away; the stride-1 ``dx`` of a ``pad_d = 0`` conv is the forward
kernel at depth padding 2.

Types: x float32 or bfloat16; weights are rounded to x's type (as the JAX
modules cast their float32 parameters to the compute type; the tensor-core
kernels read them packed by ``pack_k3_weights``), products accumulate in
float32, and the output is rounded to x's type once.  The
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
    "conv3d_k3": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "conv3d_point": [_I, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
}
_BLOCK_SIGNATURES = {
    "conv3d_k3_block": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
# the k3 entry points take the depth padding (``pad_d``) after the stride
_WGRAD_SIGNATURES = {
    "conv3d_k3_wgrad_chunks": [_I, _I, _I, _I, _I, _I, _I, _I],
    "conv3d_k3_wgrad": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P],
}
_MMA_SIGNATURES = {
    "conv3d_k3_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "conv3d_k3_block_mma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "conv3d_k3_dx_s2_mma": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_int), _I, _P],
    "conv3d_k3_wgrad_mma_chunks": [_I, _I, _I, _I, _I, _I, _I, _I],
    "conv3d_k3_wgrad_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
}
# csrc/channel_mix_mma.cu, shared with kernels/deconv3d.py
_MIX_SIGNATURES = {
    "conv3d_point_mma": [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _P],
    "deconv2x_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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


def strided_shape(dhw, stride: int, pad_d: int = 1) -> tuple:
    """Output sizes of a k3 conv of ``stride``, padded by 1 on H and W
    (``ceil(n / stride)``) and by ``pad_d`` on D (``(D + 2 pad_d - 3) //
    stride + 1``)."""
    d, h, w = (int(n) for n in dhw)
    return ((d + 2 * pad_d - 3) // stride + 1, -(-h // stride),
            -(-w // stride))


def _check_stride(stride: int, what: str, pad_d: int = 1,
                  d: Optional[int] = None) -> None:
    if stride not in (1, 2):
        raise ValueError(f"{what}: stride must be 1 or 2, got {stride}")
    if pad_d not in (0, 1):
        raise ValueError(f"{what}: pad_d must be 0 or 1, got {pad_d!r}")
    if d is not None and d + 2 * pad_d < 3:
        raise ValueError(f"{what}: depth {d} at pad_d {pad_d} has no output "
                         f"plane")


def zero_stuffed(g: torch.Tensor, dhw, stride: int,
                 pad_d: int = 1) -> torch.Tensor:
    """``g`` where its outputs' centre taps sit in a zero ``(B, *dhw, C)``
    tensor: the upstream gradient of a conv as its stride-1 pad-1 twin sees
    it (every ``stride``-th voxel; from plane 1 in depth at ``pad_d = 0``,
    whose output ``o`` is centred on input ``s o + 1``)."""
    if stride == 1 and pad_d == 1:
        return g
    full = g.new_zeros((g.shape[0], *dhw, g.shape[-1]))
    z0 = 1 - pad_d
    full[:, z0::stride, ::stride, ::stride][:, :g.shape[1]] = g
    return full


def bias_grad(g: torch.Tensor) -> torch.Tensor:
    """Gradient of a fused bias: g summed over the voxels, in float32."""
    return g.sum(dim=(0, 1, 2, 3), dtype=torch.float32)


# -------------------------------------------------------------- k3 conv

def _k3_math(x, wk, bk, stride=1, pad_d=1):
    """Conv3d k3 as 27 shifted channel contractions (no cuDNN), on weights
    already rounded by ``kernel_operands``, padded by 1 on H and W and by
    ``pad_d`` on D; a strided conv is the stride-1 result at the even
    voxels."""
    b, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, pad_d, pad_d))
    d = d + 2 * pad_d - 2
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


def _round8(n: int) -> int:
    return -(-int(n) // 8) * 8


def pack_k3_weights(wk: torch.Tensor) -> torch.Tensor:
    """k3 weights ``(3, 3, 3, Cin, Cout)`` in the tensor-core kernels'
    layout: a bfloat16 ``(K_pad, NP)`` matrix whose row ``tap * CP + ci``
    (``tap = kz*9 + ky*3 + kx``) holds ``w[kz, ky, kx, ci, :]``, with the
    channels padded by zeros to ``CP = ceil(Cin / 8) * 8`` rows per tap and
    ``NP = ceil(Cout / 8) * 8`` columns, and ``27 * CP`` rows padded to
    ``K_pad``, a multiple of 16 (the depth of one ``mma``).  Values are
    rounded to bfloat16 (exact for weights that ``kernel_operands``
    rounded)."""
    cin, cout = wk.shape[-2:]
    cp, npad = _round8(cin), _round8(cout)
    rows = 27 * cp
    packed = F.pad(wk.detach().to(torch.bfloat16),
                   (0, npad - cout, 0, cp - cin)).reshape(rows, npad)
    return F.pad(packed, (0, 0, 0, -(-rows // 16) * 16 - rows)).contiguous()


def pack_mix_weights(wk: torch.Tensor) -> torch.Tensor:
    """Channel-mix weights ``(*taps, Cin, Cout)`` -- ``(Cin, Cout)`` for the
    1x1x1 conv, ``(2, 2, 2, Cin, Cout)`` for the transposed conv -- in the
    layout of ``csrc/channel_mix_mma.cu``: a bfloat16 ``(K_pad, TAPS * NP)``
    matrix whose row ``ci`` holds, at columns ``t * NP + co``, ``w[t, ci,
    co]`` of tap ``t`` (``t = a*4 + p*2 + q`` for the transposed conv), with
    ``NP = ceil(Cout / 8) * 8`` columns per tap and the rows padded to
    ``K_pad = ceil(Cin / 16) * 16`` (the depth of one ``mma``), all padding
    zero.  Values are rounded to bfloat16 (exact for weights that
    ``kernel_operands`` rounded)."""
    cin, cout = wk.shape[-2:]
    taps = wk.detach().reshape(-1, cin, cout)
    kp, npad = -(-int(cin) // 16) * 16, _round8(cout)
    make = torch.zeros if (kp, npad) != (cin, cout) else torch.empty
    packed = make((kp, taps.shape[0], npad), dtype=torch.bfloat16,
                  device=wk.device)
    packed[:cin, :, :cout] = taps.transpose(0, 1)
    return packed.view(kp, -1)


def _k3_simt(x, wk, bk, stride=1, pad_d=1):
    """Kernel A on the CUDA cores (``csrc/conv3d.cu``), float32 weights;
    takes either type (the float32 path's kernel).  ``pad_d`` 2 (stride 1)
    is the input gradient of a ``pad_d = 0`` conv."""
    b, d, h, wd, cin = x.shape
    cout = wk.shape[-1]
    y = torch.empty(b, *strided_shape((d, h, wd), stride, pad_d), cout,
                    dtype=x.dtype, device=x.device)
    lib = build.load("conv3d", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
                              _ptr(bk), y.data_ptr(), b, d, h, wd, cin, cout,
                              stride, pad_d, stream)
    build.check(rc, "conv3d_k3")
    return y


def _k3_mma(x, wk, bk, stride=1, pad_d=1):
    """Kernel A on the tensor cores (``csrc/conv3d_mma.cu``), bfloat16."""
    b, d, h, wd, cin = x.shape
    cout = wk.shape[-1]
    wpk = pack_k3_weights(wk)
    y = torch.empty(b, *strided_shape((d, h, wd), stride, pad_d), cout,
                    dtype=x.dtype, device=x.device)
    lib = build.load("conv3d_mma", _MMA_SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_mma(x.data_ptr(), wpk.data_ptr(), _ptr(bk),
                                  y.data_ptr(), b, d, h, wd, cin, cout,
                                  stride, pad_d, stream)
    build.check(rc, "conv3d_k3")
    return y


def _k3_cuda(x, wk, bk, stride=1, pad_d=1):
    y = (_k3_mma if x.dtype == torch.bfloat16 else _k3_simt)(x, wk, bk,
                                                               stride, pad_d)
    conv3d_k3.launches += 1
    return y


def _k3_op(x, wk, bk, stride=1, pad_d=1):
    return _k3_math(x, wk, bk, stride, pad_d) if x.device.type == "cpu" \
        else _k3_cuda(x, wk, bk, stride, pad_d)


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    stride: int = 1, pad_d: int = 1) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_k3`` (forward only)."""
    _check_stride(stride, "conv3d_k3", pad_d, x.shape[1])
    return _k3_math(x, *kernel_operands(x, w, bias), stride, pad_d)


def adjoint_k3_weights(wk: torch.Tensor) -> torch.Tensor:
    """``w_t[kz, ky, kx, co, ci] = w[2-kz, 2-ky, 2-kx, ci, co]``: the k3
    conv with these weights is the adjoint of the conv with ``w``."""
    return wk.flip(0, 1, 2).transpose(3, 4).contiguous()


def parity_tap_table(pad_d: int = 1) -> tuple:
    """The taps of the stride-2 k3 conv's input gradient by parity class.

    Input ``i`` meets output ``o`` through tap ``k`` where ``i = 2o + k - 1``:
    per axis, an even ``i`` through tap 1 (``o = i / 2``) and an odd ``i``
    through taps 0 (``o = (i + 1) / 2``) and 2 (``o = (i - 1) / 2``).  Class
    ``pz*4 + py*2 + px`` holds the input voxels of those parities; its
    entry lists its taps ``kz*9 + ky*3 + kx`` (1, 2, 4 or 8 of them, 27 in
    all).  Tap ``k`` of parity ``p`` reads the gradient at ``q + (p + 1 -
    k) // 2`` for input ``2q + p``.  At depth padding ``pad_d = 0`` depth
    has ``i = 2o + k``: the depth parities trade their taps (an even ``i``
    through taps 0 and 2, an odd one through tap 1), and tap ``kz`` of
    parity ``pz`` reads the gradient at ``q + (pz - kz) // 2``."""
    per_parity = ((1,), (0, 2))
    per_parity_z = per_parity if pad_d == 1 else per_parity[::-1]
    return tuple(
        tuple(9 * kz + 3 * ky + kx for kz in per_parity_z[cls >> 2]
              for ky in per_parity[(cls >> 1) & 1]
              for kx in per_parity[cls & 1])
        for cls in range(8))


def _tap_table_arg(pad_d: int = 1):
    """``parity_tap_table`` as the C entry point takes it: 8 tap counts,
    then 8 x 8 taps (zero past each count)."""
    table = parity_tap_table(pad_d)
    flat = [len(t) for t in table]
    for taps in table:
        flat += list(taps) + [0] * (8 - len(taps))
    return (ctypes.c_int * len(flat))(*flat)


def _dx_math(g, wt, dhw, stride, pad_d=1):
    """The plain input gradient: the stride-1 pad-1 conv, with the adjoint
    weights ``wt`` (``adjoint_k3_weights``), of the upstream gradient ``g``
    put where its outputs' centre taps sit in a zero tensor of the input's
    size ``dhw`` (``zero_stuffed``)."""
    return _k3_math(zero_stuffed(g, dhw, stride, pad_d), wt, None)


def _dx_s2_mma(g, wt, dhw, pad_d=1):
    """The stride-2 input gradient on the tensor cores, by parity class."""
    b, cg = g.shape[0], g.shape[-1]
    cx = wt.shape[-1]
    wpk = pack_k3_weights(wt)
    dx = torch.empty(b, *dhw, cx, dtype=g.dtype, device=g.device)
    lib = build.load("conv3d_mma", _MMA_SIGNATURES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_dx_s2_mma(
            g.data_ptr(), wpk.data_ptr(), dx.data_ptr(), b,
            *(int(n) for n in dhw), cg, cx, _tap_table_arg(pad_d), pad_d,
            stream)
    build.check(rc, "conv3d_k3 (stride-2 input gradient)")
    conv3d_k3.launches += 1
    return dx


def _dx_cuda(g, wt, dhw, stride, pad_d=1):
    if stride == 2 and g.dtype == torch.bfloat16:
        return _dx_s2_mma(g, wt, tuple(dhw), pad_d)
    if stride == 1 and pad_d == 0:
        # output o of the pad-0 conv meets inputs o .. o + 2: the adjoint is
        # the forward kernel at depth padding 2 on g as it is
        return _k3_cuda(g, wt, None, 1, 2)
    return _k3_cuda(zero_stuffed(g, dhw, stride, pad_d), wt, None)


def _dx_op(g, wt, dhw, stride, pad_d=1):
    return _dx_math(g, wt, dhw, stride, pad_d) if g.device.type == "cpu" \
        else _dx_cuda(g, wt, dhw, stride, pad_d)


class _ConvK3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, pad_d):
        wk, bk = kernel_operands(x, w, bias)
        ctx.save_for_backward(x, wk)
        ctx.has_bias = bias is not None
        ctx.stride = stride
        ctx.pad_d = pad_d
        return _k3_op(x, wk, bk, stride, pad_d)

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        g = upstream(g, x)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _dx_op(g, adjoint_k3_weights(wk), x.shape[1:4], ctx.stride,
                        ctx.pad_d)
        if ctx.needs_input_grad[1]:
            dw = conv3d_k3_wgrad(x, g, ctx.stride, ctx.pad_d)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = bias_grad(g)
        return dx, dw, db, None, None


def conv3d_k3(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              stride: int = 1, pad_d: int = 1) -> torch.Tensor:
    """Conv3d kernel 3, stride 1 or 2, zero padding 1 on H and W and
    ``pad_d`` on D; differentiable in x, w and bias.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(3, 3, 3, Cin, Cout)`` (flax's DHWIO layout).
      bias: optional ``(Cout,)``, added in float32 before the output is
        rounded.
      stride: 1, or 2 for ``ceil(n / 2)`` outputs per axis.
      pad_d: 1, or 0 for a depth shard carrying a one-plane halo on each
        side (``D - 2`` output planes at stride 1, ``(D - 3) // 2 + 1`` at
        stride 2).

    Returns ``(B, D', H', W', Cout)`` in x's type.
    """
    check_operands(x, w, bias, (3, 3, 3), "conv3d_k3")
    _check_stride(stride, "conv3d_k3", pad_d, x.shape[1])
    return _ConvK3.apply(x, w, bias, stride, pad_d)


conv3d_k3.launches = 0


def _check_input_grad_operands(g, w, dhw, stride, pad_d=1):
    what = "conv3d_k3_input_grad"
    _check_stride(stride, what, pad_d, int(dhw[0]) if len(dhw) else None)
    if len(dhw) != 3 or g.dim() != 5 \
            or tuple(g.shape[1:4]) != strided_shape(dhw, stride, pad_d):
        raise ValueError(f"{what}: g must be (B, ceil(n / stride) per axis "
                         f"of {tuple(dhw)} (depth (D + 2 pad_d - 3) // "
                         f"stride + 1 at pad_d {pad_d}): "
                         f"{strided_shape(dhw, stride, pad_d)}, Cout), got "
                         f"{tuple(g.shape)}")
    if g.dtype not in _DTYPES:
        raise TypeError(f"{what}: g must be float32 or bfloat16, got "
                        f"{g.dtype}")
    if not g.is_contiguous():
        raise ValueError(f"{what}: g must be contiguous")
    if tuple(w.shape[:3]) != (3, 3, 3) or w.dim() != 5 \
            or w.shape[-1] != g.shape[-1]:
        raise ValueError(f"{what}: w must be (3, 3, 3, Cin, {g.shape[-1]}), "
                         f"got {tuple(w.shape)}")
    if w.device != g.device:
        raise ValueError(f"{what}: operands on {g.device} and {w.device}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {g.device}")


def conv3d_k3_input_grad(g: torch.Tensor, w: torch.Tensor, dhw,
                         stride: int = 1, pad_d: int = 1) -> torch.Tensor:
    """The input gradient of ``conv3d_k3(x, w, stride=stride)`` for an
    input of spatial size ``dhw``, as its backward computes it (one launch
    of kernel A on the card).

    Args:
      g: the gradient of the conv's output ``(B, D', H', W', Cout)``,
        float32 or bfloat16, contiguous.
      w: the conv's weights ``(3, 3, 3, Cin, Cout)``, rounded to g's type.
      dhw: the input's ``(D, H, W)``.
      stride: the conv's stride, 1 or 2.
      pad_d: the conv's depth padding, 1 or 0.

    Returns ``(B, D, H, W, Cin)`` in g's type.
    """
    _check_input_grad_operands(g, w, dhw, stride, pad_d)
    wk, _ = kernel_operands(g, w, None)
    return _dx_op(g, adjoint_k3_weights(wk), tuple(int(n) for n in dhw),
                  stride, pad_d)


def conv3d_k3_input_grad_plain(g: torch.Tensor, w: torch.Tensor, dhw,
                               stride: int = 1,
                               pad_d: int = 1) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_k3_input_grad``: the stride-1
    conv of the zero-stuffed gradient with the adjoint weights."""
    _check_input_grad_operands(g, w, dhw, stride, pad_d)
    wk, _ = kernel_operands(g, w, None)
    return _dx_math(g, adjoint_k3_weights(wk), tuple(int(n) for n in dhw),
                    stride, pad_d)


# ----------------------------------------- k3 conv, p_blk planes per step

def _check_p_blk(p_blk) -> None:
    if isinstance(p_blk, bool) or not isinstance(p_blk, int) \
            or not 1 <= p_blk <= 8:
        raise ValueError(f"conv3d_k3_block: p_blk must be an int in 1..8, "
                         f"got {p_blk!r}")


def _block_simt(x, wk, p_blk):
    """Kernel K on the CUDA cores (``csrc/conv3d_block.cu``), float32
    weights; takes either type (the float32 path's kernel)."""
    b, d, h, wd, cin = x.shape
    cout = wk.shape[-1]
    y = torch.empty(b, d, h, wd, cout, dtype=x.dtype, device=x.device)
    lib = build.load("conv3d_block", _BLOCK_SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_block(_DTYPES[x.dtype], x.data_ptr(),
                                 wk.data_ptr(), y.data_ptr(), b, d, h, wd,
                                 cin, cout, p_blk, stream)
    build.check(rc, "conv3d_k3_block")
    return y


def _block_mma(x, wk, p_blk):
    """Kernel K on the tensor cores (``csrc/conv3d_mma.cu``), bfloat16."""
    b, d, h, wd, cin = x.shape
    cout = wk.shape[-1]
    wpk = pack_k3_weights(wk)
    y = torch.empty(b, d, h, wd, cout, dtype=x.dtype, device=x.device)
    lib = build.load("conv3d_mma", _MMA_SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_block_mma(x.data_ptr(), wpk.data_ptr(),
                                     y.data_ptr(), b, d, h, wd, cin, cout,
                                     p_blk, stream)
    build.check(rc, "conv3d_k3_block")
    return y


def _block_cuda(x, wk, p_blk):
    y = (_block_mma if x.dtype == torch.bfloat16 else _block_simt)(x, wk,
                                                                   p_blk)
    conv3d_k3_block.launches += 1
    return y


def conv3d_k3_block_plain(x: torch.Tensor, w: torch.Tensor,
                          p_blk: int = 4) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_k3_block``: the k3 conv's 27
    shifted contractions (``p_blk`` splits the kernel's work and does not
    change the function)."""
    _check_p_blk(p_blk)
    return _k3_math(x, *kernel_operands(x, w, None))


def conv3d_k3_block(x: torch.Tensor, w: torch.Tensor,
                    p_blk: int = 4) -> torch.Tensor:
    """Conv3d kernel 3, stride 1, zero padding 1, no bias, computed
    ``p_blk`` output planes at a time; the same function as ``conv3d_k3(x,
    w)``.  On the card a bfloat16 tensor goes to the tensor cores
    (``csrc/conv3d_mma.cu``: kernel A's implicit GEMM with a tile ``p_blk``
    planes deep), a float32 one to the CUDA cores
    (``csrc/conv3d_block.cu``).  Forward only, as the JAX
    package's ``packed_conv3d_block``: it raises where autograd would need
    its gradient.

    Args:
      x: ``(B, D, H, W, Cin)`` float32 or bfloat16, contiguous.
      w: ``(3, 3, 3, Cin, Cout)``, rounded to x's type.
      p_blk: output planes per block of the CUDA kernels, 1..8; any depth
        (the tail block is guarded in the kernels).

    Returns ``(B, D, H, W, Cout)`` in x's type.
    """
    check_operands(x, w, None, (3, 3, 3), "conv3d_k3_block")
    _check_p_blk(p_blk)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "conv3d_k3_block is forward only and has no gradient (as the JAX "
            "package's packed_conv3d_block): call it under torch.no_grad() "
            "or use conv3d_k3, the differentiable conv")
    wk, _ = kernel_operands(x, w, None)
    if x.device.type == "cpu":
        return _k3_math(x, wk, None)
    return _block_cuda(x, wk, p_blk)


conv3d_k3_block.launches = 0


# ------------------------------------------------- k3 weight gradient

def _wgrad_math(x, g, stride=1, pad_d=1):
    b, d, h, wd, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, pad_d, pad_d))
    # the stride-1 frame: output j of the stride-1 conv reads xp[j .. j + 2]
    d = d + 2 * pad_d - 2
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


def _wgrad_simt(x, g, stride=1, pad_d=1):
    """Kernel D on the CUDA cores (``csrc/conv3d_wgrad.cu``); takes either
    type (the float32 path's kernel)."""
    b, d, h, wd, cin = x.shape
    cout = g.shape[-1]
    lib = build.load("conv3d_wgrad", _WGRAD_SIGNATURES)
    chunks = lib.conv3d_k3_wgrad_chunks(b, d, h, wd, cin, cout, stride,
                                           pad_d)
    partial = torch.empty(chunks, 27, cin, cout, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(3, 3, 3, cin, cout, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_wgrad(_DTYPES[x.dtype], x.data_ptr(),
                                    g.data_ptr(), partial.data_ptr(),
                                    dw.data_ptr(), b, d, h, wd, cin, cout,
                                    stride, pad_d, stream)
    build.check(rc, "conv3d_k3_wgrad")
    return dw


def _wgrad_mma(x, g, stride=1, pad_d=1):
    """Kernel D on the tensor cores (``csrc/conv3d_mma.cu``), bfloat16."""
    b, d, h, wd, cin = x.shape
    cout = g.shape[-1]
    lib = build.load("conv3d_mma", _MMA_SIGNATURES)
    chunks = lib.conv3d_k3_wgrad_mma_chunks(b, d, h, wd, cin, cout, stride,
                                               pad_d)
    partial = torch.empty(chunks, 27, cin, cout, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(3, 3, 3, cin, cout, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_k3_wgrad_mma(x.data_ptr(), g.data_ptr(),
                                        partial.data_ptr(), dw.data_ptr(), b,
                                        d, h, wd, cin, cout, stride, pad_d,
                                        stream)
    build.check(rc, "conv3d_k3_wgrad")
    return dw


def _wgrad_cuda(x, g, stride=1, pad_d=1):
    dw = (_wgrad_mma if x.dtype == torch.bfloat16 else _wgrad_simt)(
        x, g, stride, pad_d)
    conv3d_k3_wgrad.launches += 1
    return dw


def _check_wgrad_operands(x: torch.Tensor, g: torch.Tensor,
                          stride: int = 1, pad_d: int = 1) -> None:
    what = "conv3d_k3_wgrad"
    _check_stride(stride, what, pad_d,
                  int(x.shape[1]) if x.dim() == 5 else None)
    if x.dim() != 5 or g.dim() != 5 or g.shape[0] != x.shape[0] \
            or tuple(g.shape[1:4]) != strided_shape(x.shape[1:4], stride,
                                                    pad_d):
        raise ValueError(f"{what}: x (B, D, H, W, Cin) and g (B, D, H, W, "
                         f"Cout) must share their voxels (ceil(n / stride) "
                         f"of them at stride {stride}; depth (D + 2 pad_d - "
                         f"3) // stride + 1 at depth padding {pad_d}), got "
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
                          stride: int = 1, pad_d: int = 1) -> torch.Tensor:
    """The plain PyTorch version of ``conv3d_k3_wgrad``: 27 shifted
    contractions over the voxels of the zero-padded x, in float32 (a
    strided g is first put at the even voxels of a zero tensor)."""
    _check_wgrad_operands(x, g, stride, pad_d)
    return _wgrad_math(x, g, stride, pad_d)


def conv3d_k3_wgrad(x: torch.Tensor, g: torch.Tensor,
                    stride: int = 1, pad_d: int = 1) -> torch.Tensor:
    """Weight gradient of ``conv3d_k3``::

        dW[kz, ky, kx, ci, co] = sum_{b,d,h,w} x[b, s d+kz-p, s h+ky-1,
                                                 s w+kx-1, ci] * g[b, d, h, w, co]

    with ``s`` the stride, ``p`` the depth padding ``pad_d`` (1, or 0 for a
    depth shard carrying a one-plane halo) and out-of-volume x read as
    zero.

    Args:
      x: the conv's input ``(B, D, H, W, Cin)``, float32 or bfloat16,
        contiguous.
      g: the gradient of the conv's output ``(B, D', H', W', Cout)`` in
        x's type, contiguous (``ceil(n / stride)`` voxels per axis).
      stride: the conv's stride, 1 or 2.
      pad_d: the conv's depth padding, 1 or 0.

    Returns ``(3, 3, 3, Cin, Cout)`` float32 (products accumulated in
    float32).  The CUDA kernels (tensor cores for bfloat16, CUDA cores for
    float32) sum in a fixed order, so the result is the same from run to
    run.
    """
    _check_wgrad_operands(x, g, stride, pad_d)
    if x.device.type == "cpu":
        return _wgrad_math(x, g, stride, pad_d)
    return _wgrad_cuda(x, g, stride, pad_d)


conv3d_k3_wgrad.launches = 0


# ------------------------------------------------------------ 1x1x1 conv

def _point_weight(w: torch.Tensor) -> torch.Tensor:
    return w.reshape(w.shape[-2:]) if w.dim() == 5 else w


def _point_math(x, wk, bk):
    out = torch.einsum("bdhwi,io->bdhwo", x.float(), wk)
    if bk is not None:
        out += bk
    return out.to(x.dtype)


def _point_simt(x, wk, bk):
    """Kernel B on the CUDA cores (``csrc/conv3d.cu`` through
    ``csrc/channel_mix.cuh``), float32 weights; takes either type (the
    float32 path's kernel)."""
    cout = wk.shape[-1]
    y = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype, device=x.device)
    lib = build.load("conv3d", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_point(_DTYPES[x.dtype], x.data_ptr(), wk.data_ptr(),
                              _ptr(bk), y.data_ptr(), x.numel() // x.shape[-1],
                              x.shape[-1], cout, stream)
    build.check(rc, "conv3d_point")
    return y


def _point_mma(x, wk, bk):
    """Kernel B on the tensor cores (``csrc/channel_mix_mma.cu``),
    bfloat16."""
    cout = wk.shape[-1]
    wpk = pack_mix_weights(wk)
    y = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype, device=x.device)
    lib = build.load("channel_mix_mma", _MIX_SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3d_point_mma(x.data_ptr(), wpk.data_ptr(), _ptr(bk),
                                  y.data_ptr(), x.numel() // x.shape[-1],
                                  x.shape[-1], cout, stream)
    build.check(rc, "conv3d_point")
    return y


def _point_cuda(x, wk, bk):
    y = (_point_mma if x.dtype == torch.bfloat16 else _point_simt)(x, wk, bk)
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
