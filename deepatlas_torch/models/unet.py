"""3-D U-Nets: the configurable ``UNetTemplate`` (``UNet_light`` is its
registered instantiation) and the fixed ``UNet``.

Counterparts of ``deepatlas_tpu/models/unet.py::UNetTemplate`` for the
maxpool-down / deconv-up plan, and of its ``UNet`` (ec0..ec7 with three
max-pools and a 512-channel bottleneck, three k2 s2 transposed convs with
skip concats, six decoder k3 convs, the 1x1x1 class head), which is that
template at the fixed plan's channels.  The JAX package runs its shallow
levels on lane-packed Pallas kernels and its deep levels on XLA
convolutions, a split that exists only for the TPU's lane tiles; here every
k3 conv, deconv and the class head run on the hand-written kernels, and
max-pool, concat, bias, BatchNorm and activation are plain torch ops.

Inputs are channel-last ``(B, D, H, W, C)``; outputs are raw logits
``(B, D, H, W, n_classes)``.

Rematerialization: ``remat=True`` (the JAX models' field of that name)
sets ``remat`` on every ``ConvBlock`` and ``DeconvBlock`` (``layers``): a
differentiated train-mode forward keeps each block's input only and
recomputes the block in the backward pass.  The 1x1x1 head and the
max-pools stay outside the recompute, as in the JAX package.

Depth sharding: ``spatial_axis`` (a mesh ``Axis``, set for a forward by
``layers.use_spatial_axis``) runs the net on one depth shard, every k3 conv
on kernel A with depth padding 0 behind a one-plane halo exchange,
BatchNorm moments summed over the shards, the pool, the k2 s2 deconvs and
the head shard-local: the sharded forward is the unsharded one.  The
shard's depth must satisfy the levels' divisibility rule on its own.
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
    input's type); parameters stay float32.  ``remat`` recomputes every
    conv and deconv block in the backward pass (module docstring).
    """
    spatial_axis = None

    def __init__(self, encoders: Sequence[Sequence[int]],
                 decoders: Sequence[Sequence[int]], in_channel: int = 1,
                 n_classes: int = 2, bias: bool = False, BN: bool = False,
                 act: str = "ReLU", dtype: Optional[torch.dtype] = None,
                 remat: bool = False):
        super().__init__()
        self.encoders = tuple(tuple(p) for p in encoders)
        self.decoders = tuple(tuple(p) for p in decoders)
        self.dtype = dtype
        levels = len(self.encoders)
        if len(self.decoders) != levels - 1:
            raise ValueError("a U-Net has one decoder level per pooling")

        def cb(cin, f):
            return ConvBlock(cin, f, use_bias=bias, batchnorm=BN, act=act,
                             remat=remat)

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
                                        batchnorm=BN, act=act, remat=remat))
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


# the fixed UNet's plan as UNetTemplate channel tuples: ec0 1->32, ec1
# 32->64 | pool | ec2 64->64, ec3 64->128 | pool | ec4 128->128, ec5
# 128->256 | pool | ec6 256->256, ec7 256->512; then per level the up-conv
# (512, 256, 128 channels kept), the concat with the skip and two convs
UNET_ENCODERS = ((32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
UNET_DECODERS = ((512, 256, 256), (256, 128, 128), (128, 64, 64))


class UNet(UNetTemplate):
    """The fixed 3-pool U-Net with ReLU activations; the JAX ``UNet``'s
    keywords.

    Its widest convs run kernel A at Cin 768 (the 512-channel up-conv
    concatenated with the 256-channel skip), kernel C at 512 -> 512.
    ``spatial_axis`` (a mesh ``Axis``, or None) shards depth as in
    ``UNetTemplate``.
    """

    def __init__(self, in_channel: int = 1, n_classes: int = 2,
                 bias: bool = False, BN: bool = False,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 spatial_axis=None):
        super().__init__(UNET_ENCODERS, UNET_DECODERS, in_channel=in_channel,
                         n_classes=n_classes, bias=bias, BN=BN, act="ReLU",
                         dtype=dtype, remat=remat)
        if spatial_axis is not None:
            for m in self.modules():
                if hasattr(m, "spatial_axis"):
                    m.spatial_axis = spatial_axis
