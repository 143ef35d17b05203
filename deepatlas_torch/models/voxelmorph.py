"""VoxelMorph-CVPR2018 registration network + spatial transformer.

Counterpart of ``deepatlas_tpu/models/voxelmorph.py``: a 5-level
strided-conv encoder over the concatenated (source, target) pair, a decoder
with nearest-neighbour upsampling to the matching encoder sizes and
channel-concat skips, a 3-channel flow head without activation, and a
trilinear warp of the source by ``displacement + identity``.  ReLU, bias, no
BatchNorm.

The JAX package has two trunks (XLA convolutions, or its lane-packed TPU
kernels on the two shallow levels) that compute the same function; here
there is one: every conv runs on the hand-written k3 kernel (the strided
ones through its stride argument, ``layers.ConvBlock``), the decoder's last
upsample, to full resolution, on the k2 s2 transposed-conv kernel with the
identity bank where it is an exact doubling (``kernels.nearest_up2x``, as
the packed trunk's ``packed_nearest_up2``), and the warp on the warp kernels
(``kernels.grid_sample``).  Parameters of either JAX tree
convert with ``convert.voxelmorph_from_flax``.

Channel-last layout; the displacement and deformation fields are
``(B, D, H, W, 3)`` float32, last axis (x, y, z) in normalized [-1, 1]
units.  The head's output is cast to float32 and the warp runs in float32
whatever the trunk's compute type: a bfloat16 displacement would quantize
voxel coordinates too coarsely for sub-voxel registration.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels import grid_sample, nearest_up2x
from ..ops import identity_grid_batch, nearest_resize
from .layers import ConvBlock


class VoxelMorphCVPR2018(nn.Module):
    """Args:
      enc_filters / dec_filters: five channel counts each.
      dtype: the trunk's compute type (``torch.bfloat16`` or None for the
        input's type); parameters stay float32.
      max_disp: the warp clamps each axis of the displacement to
        +-``max_disp`` voxels (the field saturates past the bound); None
        warps unclamped.
      flow_scale: constant multiplier on the predicted displacement (1.0 =
        the reference semantics).
    """

    def __init__(self, input_channel: int = 2, output_channel: int = 3,
                 enc_filters: Sequence[int] = (16, 32, 32, 32, 32),
                 dec_filters: Sequence[int] = (32, 32, 32, 8, 8),
                 dtype: Optional[torch.dtype] = None,
                 max_disp: Optional[int] = 8, flow_scale: float = 1.0):
        super().__init__()
        self.enc_filters = tuple(int(f) for f in enc_filters)
        self.dec_filters = tuple(int(f) for f in dec_filters)
        if len(self.enc_filters) != 5 or len(self.dec_filters) != 5:
            raise ValueError("VoxelMorphCVPR2018 takes five encoder and "
                             "five decoder widths")
        self.dtype = dtype
        self.max_disp = max_disp
        self.flow_scale = float(flow_scale)
        e, d = self.enc_filters, self.dec_filters

        self.enc = nn.ModuleList()
        cin = input_channel
        for i, f in enumerate(e):
            self.enc.append(ConvBlock(cin, f, stride=1 if i == 0 else 2))
            cin = f
        # decoder inputs: e5; cat(d1, e4); cat(d2, e3); cat(d3, e2); d4
        dec_in = (e[4], d[0] + e[3], d[1] + e[2], d[2] + e[1], d[3])
        self.dec = nn.ModuleList(ConvBlock(ci, f)
                                 for ci, f in zip(dec_in, d))
        self.head = ConvBlock(d[4] + e[0], output_channel, act="None")

    def trunk(self, source: torch.Tensor, target: torch.Tensor,
              train: bool = False) -> torch.Tensor:
        """The float32 displacement field ``(B, D, H, W, 3)``."""
        x = torch.cat([source, target], dim=-1)
        x = x.to(self.dtype or x.dtype).contiguous()
        encs = []
        for blk in self.enc:
            x = blk(x, train)
            encs.append(x)
        e1, e2, e3, e4, e5 = encs

        def up(h, like):
            return nearest_resize(h, like.shape[1:4])

        d1 = self.dec[0](up(e5, e4), train)
        d2 = self.dec[1](up(torch.cat([d1, e4], dim=-1), e3), train)
        d3 = self.dec[2](up(torch.cat([d2, e3], dim=-1), e2), train)
        d4 = self.dec[3](torch.cat([d3, e2], dim=-1), train)
        if all(2 * n == m for n, m in zip(d4.shape[1:4], e1.shape[1:4])):
            d4 = nearest_up2x(d4)
        else:                       # an odd side: e1 is one voxel short
            d4 = up(d4, e1)
        d5 = self.dec[4](d4, train)
        return self.head(torch.cat([d5, e1], dim=-1), train).float()

    def deformation(self, source: torch.Tensor, target: torch.Tensor,
                    train: bool = False):
        """``(disp_field, deform_field)`` without the warp: what a caller
        that samples other volumes than ``source`` needs (the joint
        training's seg phase)."""
        disp = self.trunk(source, target, train)
        if self.flow_scale != 1.0:
            disp = disp * self.flow_scale
        deform = disp + identity_grid_batch(source.shape, dtype=disp.dtype,
                                            device=disp.device)
        return disp, deform

    def forward(self, source: torch.Tensor, target: torch.Tensor,
                train: bool = False):
        """Register ``source`` onto ``target``, both ``(B, D, H, W, C)``
        (C normally 1).  Returns ``(disp_field, warped_source,
        deform_field)``."""
        disp, deform = self.deformation(source, target, train)
        warped = grid_sample(source.float(), deform, max_disp=self.max_disp)
        return disp, warped, deform
