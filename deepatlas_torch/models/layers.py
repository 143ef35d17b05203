"""Building-block layers of the 3-D networks, on channel-last tensors.

Counterparts of ``deepatlas_tpu/models/layers.py`` (ConvBlock, DeconvBlock,
max_pool_3d) whose convolutions run on the hand-written
kernels of ``deepatlas_torch.kernels``.  Parameters are float32 in the JAX
package's layouts (conv kernels ``(k, k, k, Cin, Cout)``), so converted
checkpoints need no transposes; the blocks compute in their input's type.

Depth sharding (``parallel/spatial.py``): every block and the BatchNorm
carry ``spatial_axis``, a mesh ``Axis`` or None, set for a forward by
``use_spatial_axis(model, axis)``.  A ``ConvBlock`` then reads one
neighbour plane on each side through ``ops.halo.halo_exchange_d`` and runs
kernel A with depth padding 0 (the unsharded SAME conv: stride 1, and
stride 2 on an even shard depth), a ``DeconvBlock`` (kernel == stride) and
max-pool are shard-local, and BatchNorm sums its moments over the shards.

Rounding points in bfloat16 follow the JAX packed blocks
(``models/packed.py``): the conv output is rounded to bf16, the bias is
added in bf16, the BatchNorm affine runs in bf16 with its scale and shift
rounded to bf16, then the activation.  That epilogue (bias, BatchNorm,
activation) is one autograd Function, ``kernels.block_epilogue``: on the
card its hand-written kernels, on the CPU the same chain in torch ops, with
the closed-form backward in both.

Rematerialization (the JAX package's ``nn.remat`` on its blocks,
``deepatlas_tpu/models/unet.py::_maybe_remat``): a block built with
``remat=True`` keeps only its input for the backward pass in a
differentiated train-mode forward and recomputes its interior there
(``checkpointed``: the non-reentrant ``torch.utils.checkpoint``).  The
recompute runs inside ``recomputing()``, where BatchNorm normalizes with
the batch moments as on the first pass but leaves its running statistics
alone, so they move once per forward, as under ``nn.remat``.  The kernels
are deterministic, so the recomputed tensors, and with them the
gradients, equal the stored ones bit for bit.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import torch
import torch.utils.checkpoint
from torch import nn

from ..kernels import block_epilogue, conv3d_k3, deconv2x
from ..ops.halo import halo_exchange_d


# depth of the checkpoint recomputes running on this thread (they may nest:
# a whole network under ``checkpointed`` holds remat blocks).  Per thread:
# the non-reentrant checkpoint enters ``context_fn``'s recompute context in
# its unpack hook, on the thread that runs the backward (on the card the
# autograd engine's own), and the recompute runs there, so a forward on
# another thread meanwhile still moves its statistics.
_local = threading.local()


@contextlib.contextmanager
def _recompute():
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def recomputing() -> bool:
    """True inside a checkpoint's recompute on this thread (see
    ``checkpointed``)."""
    return getattr(_local, "depth", 0) > 0


def _recompute_context():
    return contextlib.nullcontext(), _recompute()


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` under the non-reentrant ``torch.utils.checkpoint``:
    autograd keeps ``args`` and recomputes what ``fn`` saved when the
    backward pass needs it, with ``recomputing()`` true.  The networks draw
    no random numbers, so the RNG state is not saved."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, context_fn=_recompute_context,
        preserve_rng_state=False)


def glorot_normal_(w: torch.Tensor) -> torch.Tensor:
    """flax's ``glorot_normal``: truncated normal (+-2 std) with variance
    2 / (fan_in + fan_out) over a ``(*spatial, Cin, Cout)`` kernel."""
    receptive = math.prod(w.shape[:-2])
    fan_in, fan_out = receptive * w.shape[-2], receptive * w.shape[-1]
    std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over ``(B, D, H, W)`` of a channel-last tensor,
    with the semantics of the JAX package's ``PackedBatchNorm`` and flax's
    ``nn.BatchNorm`` (eps 1e-5, momentum 0.9).

    ``train=False`` applies the affine map from the running statistics.
    ``train=True`` normalizes with the batch moments, taken in float32 from
    the compute-type input as ``var = max(E[x^2] - mean^2, 0)`` (the biased
    variance), and moves the running statistics by ``ra <- 0.9 ra + 0.1
    batch`` with that same biased variance (``torch.nn.BatchNorm3d`` would
    store the unbiased one and counts its momentum the other way round),
    except in a checkpoint's recompute (``recomputing()``): the first pass
    has moved them.  In both modes the scale ``mul`` and shift ``add`` are
    rounded to the compute type and the map is ``x * mul + add``.  It runs
    in ``kernels.block_epilogue``, whose backward is the closed-form
    derivative through the moments.

    With a ``spatial_axis`` of more than one shard, train mode sums the
    per-channel ``(sum x, sum x^2)`` over the shards in one all-reduce and
    divides by the voxels of all of them (the JAX ``PackedBatchNorm``'s
    psum of its moments); the backward sums its per-channel sums over the
    shards the same way.
    """
    spatial_axis = None

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return block_epilogue(x, None, self, "None", train,
                              update_stats=not recomputing())


class _Block(nn.Module):
    """Kernel + bias + optional BatchNorm + activation.  With ``remat`` a
    differentiated train-mode forward runs under ``checkpointed``; under
    ``torch.no_grad()`` or in eval mode the block runs once, as without.
    The recompute runs on the ``spatial_axis`` of the first pass: the
    steps leave ``use_spatial_axis`` before their backward."""
    spatial_axis = None

    def __init__(self, kernel_shape, features: int, use_bias: bool,
                 batchnorm: bool, act: str, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.weight = nn.Parameter(glorot_normal_(torch.empty(kernel_shape)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bn = BatchNorm(features) if batchnorm else None
        self.act = act

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.remat and train and torch.is_grad_enabled():
            return checkpointed(self._forward_on, x, train, self.spatial_axis)
        return self._forward(x, train)

    def _forward_on(self, x: torch.Tensor, train: bool, axis) -> torch.Tensor:
        with use_spatial_axis(self, axis):
            return self._forward(x, train)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return block_epilogue(self._op(x), self.bias, self.bn, self.act,
                              train, update_stats=not recomputing())


class ConvBlock(_Block):
    """Conv3d(k3, stride 1 or 2, p1) + bias + optional BatchNorm +
    activation.  With stride 2 output ``o`` reads input ``2 o`` and its +-1
    taps and an axis of ``n`` gives ``ceil(n / 2)`` outputs (torch's
    Conv3d(k3 s2 p1); the JAX package's packed trunk computes the same as a
    stride-1 conv and an even-index subsample)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 batchnorm: bool = False, act: str = "ReLU", stride: int = 1,
                 remat: bool = False):
        super().__init__((3, 3, 3, in_features, features), features,
                         use_bias, batchnorm, act, remat)
        if stride not in (1, 2):
            raise ValueError(f"ConvBlock stride must be 1 or 2, got {stride}")
        self.stride = stride

    def _op(self, x):
        ax = self.spatial_axis
        if ax is None:
            return conv3d_k3(x, self.weight, stride=self.stride)
        # output plane g of the stride-2 conv reads inputs 2g - 1 .. 2g + 1:
        # on an even shard depth the shard's first output starts at its
        # leading halo plane
        if self.stride == 2 and x.shape[1] % 2:
            raise ValueError(
                f"stride-2 spatial conv needs even shard depth, got "
                f"{x.shape[1]} -- use fewer shards or pad D")
        return conv3d_k3(halo_exchange_d(x, ax, 1), self.weight,
                         stride=self.stride, pad_d=0)


class DeconvBlock(_Block):
    """ConvTranspose3d(k2 s2) + bias + optional BatchNorm + activation.
    The kernel is ``(2, 2, 2, Cin, Cout)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 batchnorm: bool = False, act: str = "ReLU",
                 remat: bool = False):
        super().__init__((2, 2, 2, in_features, features), features,
                         use_bias, batchnorm, act, remat)

    def _op(self, x):
        return deconv2x(x, self.weight)


@contextlib.contextmanager
def use_spatial_axis(model: nn.Module, axis):
    """Run ``model`` depth-sharded over ``axis`` (a mesh ``Axis``) inside
    the block: every submodule with a ``spatial_axis`` attribute takes it,
    and gets back what it had on exit.  The parameters are the same
    tensors, as the JAX tier's ``dataclasses.replace(model,
    spatial_axis=...)`` shares its parameter tree."""
    if getattr(model, "spatial_axis", "missing") == "missing":
        raise ValueError(
            f"{type(model).__name__} has no spatial_axis support; spatial "
            f"sharding covers the UNetTemplate family and VoxelMorph")
    mods = [m for m in model.modules() if hasattr(m, "spatial_axis")]
    saved = [m.__dict__.get("spatial_axis", _UNSET) for m in mods]
    for m in mods:
        m.spatial_axis = axis
    try:
        yield model
    finally:
        for m, v in zip(mods, saved):
            if v is _UNSET:
                m.__dict__.pop("spatial_axis", None)
            else:
                m.spatial_axis = v


_UNSET = object()


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool3d(window) on ``(B, D, H, W, C)`` with floor semantics."""
    b, d, h, w, c = x.shape
    d2, h2, w2 = d // window, h // window, w // window
    x = x[:, :d2 * window, :h2 * window, :w2 * window]
    return x.reshape(b, d2, window, h2, window, w2, window, c).amax(
        dim=(2, 4, 6))
