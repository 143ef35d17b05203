"""Halo exchange for depth-sharded volumes, and the global-coordinate warp.

Counterpart of ``deepatlas_tpu/ops/halo.py``.  The spatial tier
(``parallel/spatial.py``) splits the D axis of a volume over the ranks of a
mesh axis; a 3x3x3 conv then needs its neighbours' boundary planes.
``halo_exchange_d`` sends ``halo`` planes down and up the axis with
point-to-point sends (NCCL: one ``batch_isend_irecv``; gloo: through host
buffers, see ``parallel/mesh.py``) and is an ``autograd.Function`` whose
backward is the exchange's adjoint: the halo planes' gradients go back to
the rank they came from and are added into its boundary planes (what the
transpose of ``ppermute`` gives the JAX package).

``shard_identity_grid`` is the global ``[-1, 1]`` identity grid sliced to a
shard, and ``spatial_grid_sample`` warps a shard from its own planes and a
``max_disp + 1``-plane halo with the displacement clamped to ``max_disp``
voxels, on the warp kernels (E forward; F and G in its backward).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

if TYPE_CHECKING:
    from ..parallel.mesh import Axis


def _exchange(lo: torch.Tensor, hi: torch.Tensor, axis: "Axis"):
    """Send ``lo`` to the rank below on ``axis`` and ``hi`` to the rank
    above; return ``(from_below, from_above)``: what the rank below sent as
    its ``hi`` and the rank above as its ``lo`` (zeros at the ends)."""
    i, n = axis.index, axis.size
    recv_lo, recv_hi = torch.zeros_like(hi), torch.zeros_like(lo)
    stage = axis.stage_p2p and lo.is_cuda
    if stage:
        # gloo's send and recv take CPU tensors only: the planes are staged
        # through host buffers, the compute stays on the card
        lo_s, hi_s = lo.cpu(), hi.cpu()
        rlo_s, rhi_s = recv_lo.cpu(), recv_hi.cpu()
    else:
        lo_s, hi_s, rlo_s, rhi_s = (lo.contiguous(), hi.contiguous(),
                                    recv_lo, recv_hi)
    ops = []
    if i > 0:
        ops.append(dist.P2POp(dist.isend, lo_s, axis.ranks[i - 1],
                              axis.group))
        ops.append(dist.P2POp(dist.irecv, rlo_s, axis.ranks[i - 1],
                              axis.group))
    if i < n - 1:
        ops.append(dist.P2POp(dist.isend, hi_s, axis.ranks[i + 1],
                              axis.group))
        ops.append(dist.P2POp(dist.irecv, rhi_s, axis.ranks[i + 1],
                              axis.group))
    if axis.backend == "nccl":
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    else:
        works = [op.op(op.tensor, op.peer, op.group) for op in ops]
        for work in works:
            work.wait()
    if stage:
        recv_lo.copy_(rlo_s)
        recv_hi.copy_(rhi_s)
    return recv_lo, recv_hi


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, halo):
        ctx.axis, ctx.halo = axis, halo
        down, up = _exchange(x[:, :halo].contiguous(),
                             x[:, -halo:].contiguous(), axis)
        return torch.cat([down, x, up], dim=1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        g = g.contiguous()
        # the leading halo came from the rank below (its last planes), the
        # trailing one from the rank above (its first planes): each goes
        # back, and what comes in lands on this shard's own boundary planes
        first, last = _exchange(g[:, :h].contiguous(),
                                g[:, -h:].contiguous(), ctx.axis)
        dx = g[:, h:-h].clone()
        dx[:, :h] += first
        dx[:, -h:] += last
        return dx, None, None


def halo_exchange_d(x: torch.Tensor, axis: Optional["Axis"],
                    halo: int = 1) -> torch.Tensor:
    """Append ``halo`` neighbour planes on each side of the D axis.

    ``x`` is this rank's shard ``(B, D_loc, ...)`` along ``axis``; returns
    ``(B, D_loc + 2 halo, ...)``.  The first and last shards receive zeros
    where no neighbour exists, which is the zero padding of a
    ``padding=halo`` conv at the volume's ends, so a k = 2 halo + 1 conv of
    the result with depth padding 0 is the unsharded SAME conv.  At one
    shard (or no axis) the exchange is that zero pad.
    """
    if x.shape[1] < halo:
        raise ValueError(
            f"shard depth {x.shape[1]} < halo {halo}; use fewer shards")
    if axis is None or axis.size == 1:
        return F.pad(x, (0, 0) * (x.dim() - 2) + (halo, halo))
    return _HaloExchange.apply(x, axis, halo)


def shard_identity_grid(local_shape, axis: Optional["Axis"],
                        dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """The global normalized identity grid ``(B, D_loc, H, W, 3)``, last
    axis ``(x, y, z)``, sliced to this rank's depth shard (``D = D_loc *
    axis size``); ``ops.grid.identity_grid_batch`` at one shard."""
    b, d_loc, h, w = (int(n) for n in local_shape[:4])
    n = 1 if axis is None else axis.size
    idx = 0 if axis is None else axis.index
    d = d_loc * n
    zs = (idx * d_loc + torch.arange(d_loc, dtype=torch.float32,
                                     device=device)) * (2.0 / (d - 1)) - 1.0
    ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=device)
    zz, yy, xx = torch.meshgrid(zs, ys, xs, indexing="ij")
    grid = torch.stack([xx, yy, zz], dim=-1).to(dtype)
    return grid[None].expand(b, d_loc, h, w, 3)


def spatial_grid_sample(vol: torch.Tensor, deform: torch.Tensor,
                        axis: Optional["Axis"], max_disp: int = 8,
                        grad: str = "full") -> torch.Tensor:
    """Depth-sharded trilinear warp: this rank's output voxels sampled from
    its planes plus a ``max_disp + 1``-plane halo.

    ``vol`` ``(B, D_loc, H, W, C)`` and ``deform`` ``(B, D_loc, H, W, 3)``
    are shards; ``deform`` holds global normalized coordinates
    (``shard_identity_grid`` plus a displacement), each axis of the
    displacement clamped to +-``max_disp`` voxels (the bound of the
    single-process warp's clamp), so every sample lies inside the halo'd
    block; samples past the volume's ends read the zero halos.  The warp is
    ``kernels.grid_sample`` on the halo'd block with z remapped into its
    frame (kernel E; F and G in the backward, ``grad`` as there).
    """
    from ..kernels import grid_sample
    b, d_loc, h, w = vol.shape[:4]
    n = 1 if axis is None else axis.size
    idx = 0 if axis is None else axis.index
    d = d_loc * n
    hp = max_disp + 1
    ident = shard_identity_grid(vol.shape, axis, device=vol.device)
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1), 2.0 / (d - 1)],
                         dtype=torch.float32, device=vol.device)
    bound = max_disp * scale
    disp = torch.maximum(torch.minimum(deform.float() - ident, bound),
                         -bound)
    grid = ident + disp
    volh = halo_exchange_d(vol, axis, hp)
    # global z to the halo'd local frame: z_local = z - z0 + hp, normalized
    # over the halo'd depth
    gz = (grid[..., 2] + 1.0) * ((d - 1) / 2.0)
    gz_loc = gz - float(idx * d_loc) + hp
    dh = d_loc + 2 * hp
    grid_loc = torch.stack([grid[..., 0], grid[..., 1],
                            gz_loc * (2.0 / (dh - 1)) - 1.0], dim=-1)
    return grid_sample(volh, grid_loc, max_disp=None, grad=grad)
