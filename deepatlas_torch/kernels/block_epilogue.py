"""The epilogue of a conv or deconv block: bias, optional BatchNorm and
activation on the block's channel-last output, as one autograd Function.

``block_epilogue`` replaces no TPU kernel: on the TPU, XLA fused this chain
into the passes around the Pallas convs.  In eager PyTorch it was ~35
launches a block, each a full pass over the tensor, and autograd kept a
float32 copy of the biased output.  On the card the Function runs the
hand-written kernels of ``csrc/block_epilogue.cu`` (their design is
described there): one read of the tensor per pass, per-block partial sums
added in a fixed order, so two runs and a remat recompute are equal bit for
bit.  Bound by bytes: in train mode 6 bytes an element forward and 10
backward in bfloat16, where the chain moved ~120-140.

The forward is the chain the blocks ran, with its rounding points in the
storage type ``T`` of ``y`` (the JAX packed blocks' order)::

    x = T(y + T(b))
    mean, var = batch moments of x in float32, var = max(E[x^2] - mean^2, 0)
                (train mode), or the running statistics (eval mode)
    mul = w * rsqrt(var + eps),  add = shift - mean * mul
    z = T(T(x * T(mul)) + T(add)),  out = act(z)

Train mode moves the running statistics by ``r <- m r + (1 - m) batch``
with the biased variance, unless ``update_stats`` is false (a remat
recompute).  With a ``spatial axis`` of more than one shard the per-channel
``(sum x, sum x^2)`` are summed over the shards (``psum_many``) and divided
by the voxels of all of them.

The backward is the closed-form derivative of that forward, with autograd's
rounding points through the chain: each rounding passes the gradient
straight through, and what autograd rounds to ``T`` is rounded to ``T``::

    dz = T(act'(z) g),  Sg = T(sum dz),  Sgx = T(sum T(dz x))  (per channel)
    dx = T(T(alpha dz) + T(beta + gamma x)),  dbias = T(sum dx)

with ``alpha = T(mul)`` (the scale that x meets in ``x * T(mul)``) and,
in train mode, ``beta``, ``gamma`` from the gradients of ``mean`` (through
the unrounded ``mul`` of ``add = shift - mean * mul``) and of the clamped
variance (``_coefficients``); the BatchNorm's scale and shift take their
gradients from ``Sg`` and ``Sgx`` (``Sg`` and ``Sgx`` are the gradients of
``T(add)`` and ``T(mul)``, summed in T as autograd sums a broadcast
operand's).  In bfloat16 the plain version so equals autograd through the
chain bit for bit but for the float32 order of a few per-channel products,
and the bias in front of a train-mode BatchNorm gets what the chain and the
JAX packed blocks give it: ``(T(mul) - mul) Sg`` and the sum's rounding.
Only ``y`` and per-channel vectors are kept for the backward pass.  Across
shards each shard's rounded sums are added over the shards before ``beta``
and ``gamma`` (the differentiable psum's backward), while the parameter
gradients keep this shard's sums.

The wrapper dispatches on the device: a CUDA tensor in float32 or
bfloat16 launches the kernels, in another type it raises; a CPU tensor (or
one on the ``meta`` device, where the conv census runs the model) runs the
plain version: the forward's ops above in torch, the closed-form backward
in torch ops.  ``block_epilogue.launches`` counts kernel launches: in train
mode with a BatchNorm 3 forward and 3 backward, and a fourth backward that
finishes the bias's gradient (the sum of dx, taken in the pass that writes
dx); in eval mode 2 forward; without a BatchNorm 1 forward and 2 backward
(1 with nothing to reduce); on more than one shard one more each way.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .conv3d import _DTYPES, _ptr

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "epilogue_moments": [_I, _I, _P, _P, _P, _L, _I, _I, _I, _P],
    "epilogue_sums": [_I, _P, _I, _I, _P, _P],
    "epilogue_stats": [_I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _F, _F, _F,
                       _I, _D, _P, _P],
    "epilogue_apply": [_I, _I, _I, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    "epilogue_backward": [_I, _I, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P,
                          _P, _L, _I, _I, _I, _P],
    "epilogue_grads": [_I, _I, _P, _I, _P, _I, _P, _P, _D, _P, _P, _P, _P,
                       _P],
}

LEAKY_SLOPE = 0.01
ACTIVATIONS = {
    "ReLU": F.relu,
    "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=LEAKY_SLOPE),
    "None": lambda x: x,
}
_ACT_CODES = {"None": 0, "ReLU": 1, "LeakyReLU": 2}

# rows of the per-channel statistics kept for the backward pass (the
# kernels' StatRow): the scale and shift as T rounds them, the mean,
# E[x^2] - mean^2 before its clamp, and rsqrt(var + eps)
MUL, ADD, MEAN, VAR_PRE, RSTD = range(5)
STAT_ROWS = 5

_VOXELS = (0, 1, 2, 3)
_THREADS = 256
MAX_PARTS = 1024


def layout(nvox: int, c: int, vec: int) -> tuple:
    """The elementwise passes' grid: ``rows`` voxels by ``c / vec`` chunks
    a block of 256 threads (``rows`` a power of two), and ``parts`` blocks,
    at most ``MAX_PARTS``, one partial sum each."""
    chunks = c // vec
    if chunks > _THREADS:
        raise ValueError(f"block_epilogue: {c} channels in chunks of {vec} "
                         f"exceed one block of {_THREADS} threads")
    rows = 1 << ((_THREADS // chunks).bit_length() - 1)
    return rows, max(1, min(-(-nvox // rows), MAX_PARTS))


class _Spec:
    """The Function's non-tensor arguments."""
    __slots__ = ("bn", "act", "train", "update", "axis", "plain")

    def __init__(self, bn, act, train, update, axis, plain):
        self.bn, self.act, self.train = bn, act, train
        self.update, self.axis, self.plain = update, axis, plain


def _sharded(axis) -> bool:
    return axis is not None and axis.size > 1


def _psum(t: torch.Tensor, axis) -> torch.Tensor:
    from ..parallel.collectives import psum_many
    return psum_many([t], axis)[0]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# ----------------------------------------------------------- plain version

def _forward_math(y, bias, weight, shift, spec):
    dt = y.dtype
    x = y if bias is None else y + bias.to(dt)
    bn, stats = spec.bn, None
    if bn is not None:
        acc = _acc(dt)
        if spec.train:
            xf = x.to(acc)
            if not _sharded(spec.axis):
                mean = xf.mean(dim=_VOXELS)
                var_pre = (xf * xf).mean(dim=_VOXELS) - mean * mean
            else:
                n = xf.numel() // xf.shape[-1] * spec.axis.size
                s = _psum(torch.stack([xf.sum(dim=_VOXELS),
                                       (xf * xf).sum(dim=_VOXELS)]),
                          spec.axis)
                mean = s[0] / n
                var_pre = s[1] / n - mean * mean
            var = var_pre.clamp(min=0.0)
            if spec.update:
                bn.running_mean.mul_(bn.momentum).add_(
                    mean, alpha=1 - bn.momentum)
                bn.running_var.mul_(bn.momentum).add_(
                    var, alpha=1 - bn.momentum)
        else:
            mean, var = bn.running_mean, bn.running_var
            var_pre = var
        rstd = torch.rsqrt(var + bn.eps)
        scale = weight * rstd
        add = shift - mean * scale
        mul_t, add_t = scale.to(dt), add.to(dt)
        x = x * mul_t + add_t
        stats = torch.stack([t.to(acc) for t in (
            mul_t, add_t, mean, var_pre, rstd)])
    return ACTIVATIONS[spec.act](x), stats


def _act_grad(g, z, act):
    """g through the activation at its input z, in g's type (torch's
    leaky_relu and threshold backward)."""
    if act == "LeakyReLU":
        return torch.where(z > 0, g, g * LEAKY_SLOPE)
    if act == "ReLU":
        return g.masked_fill(z <= 0, 0.0)
    return g


def _coefficients(mode, s, total, stats, weight, n_total):
    """beta, gamma and the gradients of the scale and the shift, per channel
    in float64, from this shard's rounded sums ``s = (Sg, Sgx)``
    and ``total``, their sums over the shards (train mode; None: one
    shard).  mode 1: eval; 2: train."""
    s0, s1 = s[0].double(), s[1].double()
    st = stats.double()
    mean, rstd = st[MEAN], st[RSTD]
    beta = gamma = torch.zeros_like(s0)
    if mode == 2:
        g0, g1 = (s0, s1) if total is None else total.double()
        dmul = g1 - mean * g0
        dvar = torch.where(st[VAR_PRE] >= 0,
                           -0.5 * dmul * weight.double() * rstd ** 3,
                           torch.zeros_like(dmul))
        dmean = -weight.double() * rstd * g0 - 2.0 * mean * dvar
        beta, gamma = dmean / n_total, 2.0 * dvar / n_total
    return beta, gamma, (s1 - mean * s0) * rstd, s0


def _backward_math(g, y, bias, weight, stats, spec, needs):
    dt = y.dtype
    acc = _acc(dt)
    x = y if bias is None else y + bias.to(dt)
    z = x if stats is None else x * stats[MUL].to(dt) + stats[ADD].to(dt)
    dz = _act_grad(g.to(dt), z, spec.act)
    # the sums in T, as autograd sums the gradient of a broadcast operand
    s = torch.stack([dz.sum(dim=_VOXELS), (dz * x).sum(dim=_VOXELS)]).to(acc)
    if stats is None:
        return dz, s[0], None, None
    n = y.numel() // y.shape[-1]
    total = None
    if spec.train and _sharded(spec.axis):
        total, n = _psum(s, spec.axis), n * spec.axis.size
    beta, gamma, dw, dshift = _coefficients(
        2 if spec.train else 1, s, total, stats, weight, n)
    dx = dz * stats[MUL].to(dt)
    if spec.train:
        dx = dx + (beta.to(acc) + gamma.to(acc) * x.to(acc)).to(dt)
    return dx, dx.sum(dim=_VOXELS).to(acc), dw, dshift


# ---------------------------------------------------------------- kernels

def _launch(rc: int, what: str) -> None:
    build.check(rc, f"block_epilogue {what}")
    block_epilogue.launches += 1


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().float().contiguous()


def _vec(y: torch.Tensor, c: int) -> int:
    """16-byte chunks where the channels and the pointer allow, else 1."""
    v = 16 // y.element_size()
    return v if c % v == 0 and y.data_ptr() % 16 == 0 else 1


def _voxel_stride(t: torch.Tensor) -> Optional[int]:
    """Elements between consecutive voxels when t is a channel slice of a
    channel-last tensor (dense over the voxels, unit channel stride)."""
    if t.stride(-1) != 1:
        return None
    vs, span = t.stride(3), t.stride(3)
    for d in (3, 2, 1, 0):
        if t.shape[d] != 1 and t.stride(d) != span:
            return None
        span *= t.shape[d]
    return vs


def _total(lib, partials, parts, c, axis, stream, dtype=None):
    """The partials' per-channel sums added over the shards of ``axis``
    (each shard's sums rounded to ``dtype``'s type first, where given)."""
    sums = partials.new_empty(2, c)
    _launch(lib.epilogue_sums(-1 if dtype is None else dtype,
                              partials.data_ptr(), parts, c, sums.data_ptr(),
                              stream), "sums")
    return _psum(sums, axis).contiguous()


def _forward_cuda(y, bias, weight, shift, spec):
    c = y.shape[-1]
    nvox = y.numel() // c
    dtype = _DTYPES[y.dtype]
    vec = _vec(y, c)
    rows, parts = layout(nvox, c, vec)
    b = _f32(bias)
    bn, stats = spec.bn, None
    out = torch.empty_like(y)
    lib = build.load("block_epilogue", _SIGNATURES)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bn is not None:
            for t in (bn.running_mean, bn.running_var):
                if t.dtype != torch.float32 or not t.is_contiguous():
                    raise TypeError("block_epilogue: running statistics "
                                    "must be contiguous float32")
            w, sh = _f32(weight), _f32(shift)
            stats = y.new_empty((STAT_ROWS, c), dtype=torch.float32)
            partials = total = None
            n = nvox
            if spec.train:
                partials = y.new_empty((parts, 2, c), dtype=torch.float32)
                _launch(lib.epilogue_moments(
                    dtype, vec, y.data_ptr(), _ptr(b), partials.data_ptr(),
                    nvox, c, rows, parts, stream), "moments")
                if _sharded(spec.axis):
                    total = _total(lib, partials, parts, c, spec.axis, stream)
                    n = nvox * spec.axis.size
            _launch(lib.epilogue_stats(
                dtype, int(spec.train), _ptr(partials),
                parts if spec.train else 0, _ptr(total), c, w.data_ptr(),
                sh.data_ptr(), bn.running_mean.data_ptr(),
                bn.running_var.data_ptr(), float(bn.eps), float(bn.momentum),
                float(1 - bn.momentum), int(spec.update), float(n),
                stats.data_ptr(), stream), "stats")
        _launch(lib.epilogue_apply(
            dtype, vec, _ACT_CODES[spec.act], y.data_ptr(), _ptr(b),
            _ptr(stats), out.data_ptr(), nvox, c, rows, parts, stream),
            "apply")
    return out, stats


def _backward_cuda(g, y, bias, weight, stats, spec, needs):
    c = y.shape[-1]
    nvox = y.numel() // c
    dtype = _DTYPES[y.dtype]
    vec = _vec(y, c)
    g = g.to(y.dtype)
    vs = _voxel_stride(g)
    if vs is None or (vec > 1 and (vs % vec or g.data_ptr() % 16)):
        g, vs = g.contiguous(), c
    rows, parts = layout(nvox, c, vec)
    mode = 0 if stats is None else 2 if spec.train else 1
    f32 = dict(dtype=torch.float32, device=y.device)
    dx = torch.empty_like(y) if needs[0] else None
    need_dbias = bias is not None and needs[1]
    dw = torch.empty(c, **f32) if mode and needs[2] else None
    dshift = torch.empty(c, **f32) if mode and needs[3] else None
    # two passes where dx takes the sums (train mode) or the bias's
    # gradient is the sum of dx; one pass that writes dx and sums otherwise
    two = mode == 2 or mode == 1 and need_dbias
    reduce = two or need_dbias or dw is not None or dshift is not None
    partials = torch.empty(parts, 2, c, **f32) if reduce else None
    dbias = torch.empty(c, **f32) if need_dbias and not two else None
    b = _f32(bias)
    w = _f32(weight)
    act = _ACT_CODES[spec.act]
    lib = build.load("block_epilogue", _SIGNATURES)

    def elementwise(reduce, write, coef=None):
        _launch(lib.epilogue_backward(
            dtype, vec, act, int(reduce), int(write), g.data_ptr(), vs,
            y.data_ptr(), _ptr(b), _ptr(stats), _ptr(coef), _ptr(dx),
            _ptr(partials), nvox, c, rows, parts, stream), "backward")

    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        if reduce or dx is not None:
            elementwise(reduce, not two and dx is not None)
        total, n_total = None, nvox
        if mode == 2 and _sharded(spec.axis):
            total = _total(lib, partials, parts, c, spec.axis, stream, dtype)
            n_total = nvox * spec.axis.size
        coef = torch.empty(3, c, **f32) if two else None
        if reduce:
            _launch(lib.epilogue_grads(
                dtype, mode, partials.data_ptr(), parts, _ptr(total), c,
                _ptr(stats), _ptr(w), float(n_total), _ptr(coef),
                _ptr(dbias), _ptr(dw), _ptr(dshift), stream), "grads")
        if two and (dx is not None or need_dbias):
            # dx, and with the bias its sum into the partials
            elementwise(need_dbias, dx is not None, coef)
            if need_dbias:
                sums = partials.new_empty(2, c)
                _launch(lib.epilogue_sums(
                    dtype, partials.data_ptr(), parts, c, sums.data_ptr(),
                    stream), "sums")
                dbias = sums[0]
    return dx, dbias, dw, dshift


# --------------------------------------------------------------- Function

class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias, weight, shift, spec):
        with torch.no_grad():
            out, stats = (_forward_math if spec.plain else _forward_cuda)(
                y, bias, weight, shift, spec)
        ctx.save_for_backward(y, bias, weight)
        ctx.stats = stats
        ctx.spec = spec
        return out

    @staticmethod
    def backward(ctx, g):
        y, bias, weight = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        dx, dbias, dw, dshift = (
            _backward_math if ctx.spec.plain else _backward_cuda)(
            g, y, bias, weight, ctx.stats, ctx.spec, needs)
        # the scale and the shift are parameters of one BatchNorm
        grads = [None if d is None or not need else d.to(ref.dtype)
                 for d, ref, need in zip((dbias, dw, dshift),
                                         (bias, weight, weight), needs[1:])]
        return (dx if needs[0] else None, *grads, None)


def _check(y, bias, bn, act):
    if y.dim() != 5:
        raise ValueError(f"block_epilogue: y must be (B, D, H, W, C), got "
                         f"{tuple(y.shape)}")
    if act not in ACTIVATIONS:
        raise NotImplementedError(
            f"Not Implemented activation type {act}, only "
            f"{list(ACTIVATIONS)} are available now")
    c = y.shape[-1]
    for name, t in (("bias", bias),
                    ("BatchNorm weight", None if bn is None else bn.weight)):
        if t is not None and tuple(t.shape) != (c,):
            raise ValueError(f"block_epilogue: {name} must be ({c},), got "
                             f"{tuple(t.shape)}")
    if y.device.type == "cuda" and y.dtype not in _DTYPES:
        raise TypeError(f"block_epilogue: a CUDA tensor must be float32 or "
                        f"bfloat16, got {y.dtype}")


def _apply(y, bias, bn, act, train, update_stats, plain):
    _check(y, bias, bn, act)
    spec = _Spec(bn, act, bool(train) and bn is not None, update_stats,
                 None if bn is None else bn.spatial_axis, plain)
    weight = shift = None
    if bn is not None:
        weight, shift = bn.weight, bn.bias
    return _Epilogue.apply(y.contiguous(), bias, weight, shift, spec)


def block_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   bn=None, act: str = "ReLU", train: bool = False,
                   update_stats: bool = True) -> torch.Tensor:
    """``act(BatchNorm(y + bias))`` on a block's ``(B, D, H, W, C)`` output
    in its type, differentiable in y, the bias and the BatchNorm's scale
    and shift (module docstring).

    Args:
      y: the conv's output; float32 or bfloat16 on the card.
      bias: optional ``(C,)`` float32.
      bn: None, or a BatchNorm with ``weight``, ``bias`` (``(C,)``
        parameters), ``running_mean``, ``running_var`` (``(C,)`` float32,
        moved in place in train mode), ``eps``, ``momentum`` and
        ``spatial_axis``, the depth-sharding mesh ``Axis`` or None, over
        whose shards the moments are summed (``models.layers.BatchNorm``).
      act: "LeakyReLU" (slope 0.01), "ReLU" or "None".
      train: batch moments (True) or running statistics.
      update_stats: move the running statistics in train mode (False in a
        remat recompute).
    """
    return _apply(y, bias, bn, act, train, update_stats,
                  y.device.type != "cuda")


block_epilogue.launches = 0


def block_epilogue_plain(y: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, bn=None,
                         act: str = "ReLU", train: bool = False,
                         update_stats: bool = True) -> torch.Tensor:
    """The plain PyTorch version of ``block_epilogue`` on any device (the
    same Function: the forward's torch ops, the closed-form backward)."""
    return _apply(y, bias, bn, act, train, update_stats, True)
