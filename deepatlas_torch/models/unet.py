"""The configurable 3-D U-Net ``UNetTemplate`` (``UNet_light`` is its
registered instantiation).

Counterpart of ``deepatlas_tpu/models/unet.py::UNetTemplate`` for the
maxpool-down / deconv-up plan.  The JAX package runs its shallow levels on
lane-packed Pallas kernels and its deep levels on XLA convolutions, a split
that exists only for the TPU's lane tiles; here every k3 conv, deconv and
the class head run on the hand-written kernels, and max-pool, concat, bias,
BatchNorm and activation are plain torch ops.

Inputs are channel-last ``(B, D, H, W, C)``; outputs are raw logits
``(B, D, H, W, n_classes)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels import conv3d_point
from .layers import ConvBlock, DeconvBlock, glorot_normal_, max_pool_3d


class PointConv(nn.Module):
    """1x1x1 conv (the class head); kernel ``(Cin, Cout)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool):
        super().__init__()
        self.weight = nn.Parameter(glorot_normal_(
            torch.empty(in_features, features)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3d_point(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class UNetTemplate(nn.Module):
    """Configurable U-Net with the maxpool-down / deconv-up plan.

    ``encoders`` / ``decoders`` are per-level channel tuples; the first
    encoder level is prefixed with ``in_channel``, each decoder level's
    conv chain takes the concat of its upsampled input and the skip, and
    the last level ends in a 1x1x1 conv to ``n_classes``.

    ``dtype`` is the compute type (``torch.bfloat16`` or None for the
    input's type); parameters stay float32.
    """

    def __init__(self, encoders: Sequence[Sequence[int]],
                 decoders: Sequence[Sequence[int]], in_channel: int = 1,
                 n_classes: int = 2, bias: bool = False, BN: bool = False,
                 act: str = "ReLU", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoders = tuple(tuple(p) for p in encoders)
        self.decoders = tuple(tuple(p) for p in decoders)
        self.dtype = dtype
        levels = len(self.encoders)
        if len(self.decoders) != levels - 1:
            raise ValueError("a U-Net has one decoder level per pooling")

        def cb(cin, f):
            return ConvBlock(cin, f, use_bias=bias, batchnorm=BN, act=act)

        self.enc = nn.ModuleList()
        cin = in_channel
        skip_c = []
        for i, plan in enumerate(self.encoders):
            chain = plan if i == 0 else plan[1:]
            level = nn.ModuleList()
            for f in chain:
                level.append(cb(cin, f))
                cin = f
            self.enc.append(level)
            skip_c.append(cin)
        self.ups = nn.ModuleList()
        self.dec = nn.ModuleList()
        for j, plan in enumerate(self.decoders):
            self.ups.append(DeconvBlock(cin, plan[0], use_bias=bias,
                                        batchnorm=BN, act=act))
            cin = plan[0] + skip_c[levels - 2 - j]
            level = nn.ModuleList()
            for f in plan[1:]:
                level.append(cb(cin, f))
                cin = f
            self.dec.append(level)
        self.head = PointConv(cin, n_classes, bias)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        levels = len(self.encoders)
        factor = 2 ** (levels - 1)
        if any(n % factor for n in x.shape[1:4]):
            raise ValueError(
                f"UNet with {levels} levels needs spatial dims divisible by "
                f"{factor}, got {tuple(x.shape[1:4])}")
        h = x.to(self.dtype or x.dtype).contiguous()
        skips = []
        for i, level in enumerate(self.enc):
            for blk in level:
                h = blk(h, train)
            if i < levels - 1:
                skips.append(h)
                h = max_pool_3d(h).contiguous()
        for up, level in zip(self.ups, self.dec):
            h = torch.cat([up(h, train), skips.pop()], dim=-1)
            for blk in level:
                h = blk(h, train)
        return self.head(h)
