"""Building-block layers of the 3-D networks, on channel-last tensors.

Counterparts of ``deepatlas_tpu/models/layers.py`` (ConvBlock, DeconvBlock,
max_pool_3d, get_activation) whose convolutions run on the hand-written
kernels of ``deepatlas_torch.kernels``.  Parameters are float32 in the JAX
package's layouts (conv kernels ``(k, k, k, Cin, Cout)``), so converted
checkpoints need no transposes; the blocks compute in their input's type.

Rounding points in bfloat16 follow the JAX packed blocks
(``models/packed.py``): the conv output is rounded to bf16, the bias is
added in bf16, the BatchNorm affine runs in bf16 with its scale and shift
rounded to bf16, then the activation.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import conv3d_k3, deconv2x


def get_activation(act: str) -> Callable:
    table = {
        "ReLU": F.relu,
        "LeakyReLU": lambda x: F.leaky_relu(x, negative_slope=0.01),
        "None": lambda x: x,
    }
    if act not in table:
        raise NotImplementedError(
            f"Not Implemented activation type {act}, only {list(table)} "
            f"are available now")
    return table[act]


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
    store the unbiased one and counts its momentum the other way round).
    The moments are plain tensor ops, so autograd differentiates through
    them.  In both modes the scale ``mul`` and shift ``add`` are rounded to
    the compute type and the map is ``x * mul + add``.
    """

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 1, 2, 3))
            var = ((xf * xf).mean(dim=(0, 1, 2, 3)) - mean * mean).clamp(
                min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    mean, alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(
                    var, alpha=1 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + self.eps)
        add = self.bias - mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)


class _Block(nn.Module):
    """Kernel + bias + optional BatchNorm + activation."""

    def __init__(self, kernel_shape, features: int, use_bias: bool,
                 batchnorm: bool, act: str):
        super().__init__()
        self.weight = nn.Parameter(glorot_normal_(torch.empty(kernel_shape)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.bn = BatchNorm(features) if batchnorm else None
        self.act = get_activation(act)

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self._op(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.bn is not None:
            y = self.bn(y, train)
        return self.act(y)


class ConvBlock(_Block):
    """Conv3d(k3, stride 1 or 2, p1) + bias + optional BatchNorm +
    activation.  With stride 2 output ``o`` reads input ``2 o`` and its +-1
    taps and an axis of ``n`` gives ``ceil(n / 2)`` outputs (torch's
    Conv3d(k3 s2 p1); the JAX package's packed trunk computes the same as a
    stride-1 conv and an even-index subsample)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 batchnorm: bool = False, act: str = "ReLU", stride: int = 1):
        super().__init__((3, 3, 3, in_features, features), features,
                         use_bias, batchnorm, act)
        if stride not in (1, 2):
            raise ValueError(f"ConvBlock stride must be 1 or 2, got {stride}")
        self.stride = stride

    def _op(self, x):
        return conv3d_k3(x, self.weight, stride=self.stride)


class DeconvBlock(_Block):
    """ConvTranspose3d(k2 s2) + bias + optional BatchNorm + activation.
    The kernel is ``(2, 2, 2, Cin, Cout)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 batchnorm: bool = False, act: str = "ReLU"):
        super().__init__((2, 2, 2, in_features, features), features,
                         use_bias, batchnorm, act)

    def _op(self, x):
        return deconv2x(x, self.weight)


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool3d(window) on ``(B, D, H, W, C)`` with floor semantics."""
    b, d, h, w, c = x.shape
    d2, h2, w2 = d // window, h // window, w // window
    x = x[:, :d2 * window, :h2 * window, :w2 * window]
    return x.reshape(b, d2, window, h2, window, w2, window, c).amax(
        dim=(2, 4, 6))
