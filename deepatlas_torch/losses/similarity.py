"""Image-similarity losses for registration.

Counterpart of ``deepatlas_tpu/losses/similarity.py``: global NCC, the
VoxelMorph single-window LNCC (filter 9, the recipe's similarity), the
multi-scale strided / dilated LNCC with its size-dependent schedule, and
MSE.  Local sums are separable windowed sums (``ops/window.py``).

The LNCC variances are differences of float32 window sums that nearly
cancel.  Each window sum carries the rounding of its own total only
(``ops/window.py``), so the loss and its gradient agree with a direct
window sum (``avg_pool3d``) and with float64 to float32 rounding of the
windows, on zero backgrounds too, where the variances are differences near
0: on a 64^3 brain over a 16-voxel zero border, 4e-8 in the value and
6e-7 relative in the gradient against float64
(``tests/test_torch_lncc_zero_background.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops import window_sum
from ..ops.halo import halo_exchange_d
from ..parallel.collectives import psum


def ncc_loss(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - global normalized cross-correlation, averaged over the batch."""
    b = input.shape[0]
    x = input.reshape(b, -1)
    y = target.reshape(b, -1)
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y - y.mean(dim=1, keepdim=True)
    ncc = (xc * yc).mean(dim=1) / (
        torch.sqrt((xc ** 2).mean(dim=1)) * torch.sqrt((yc ** 2).mean(dim=1)))
    return 1.0 - ncc.mean()


def mse_loss(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((input - target) ** 2)


def _lncc_cc(i_img, j_img, window, stride, dilation, eps: float):
    """Squared local correlation coefficient map for one window config."""
    win = (window, window, window) if isinstance(window, int) else window
    numel = float(win[0] * win[1] * win[2])

    i_sum = window_sum(i_img, window, stride, dilation)
    j_sum = window_sum(j_img, window, stride, dilation)
    i2_sum = window_sum(i_img ** 2, window, stride, dilation)
    j2_sum = window_sum(j_img ** 2, window, stride, dilation)
    ij_sum = window_sum(i_img * j_img, window, stride, dilation)

    i_mean = i_sum / numel
    j_mean = j_sum / numel

    cross = ij_sum - i_mean * j_sum - j_mean * i_sum + i_mean * j_mean * numel
    i_var = i2_sum - 2 * i_mean * i_sum + i_mean ** 2 * numel
    j_var = j2_sum - 2 * j_mean * j_sum + j_mean ** 2 * numel
    return (cross ** 2) / (i_var * j_var + eps)


def lncc_loss(input: torch.Tensor, target: torch.Tensor,
              filter_size: int = 9, eps: float = 1e-6,
              axis_name=None) -> torch.Tensor:
    """VoxelMorph windowed LNCC: 1 - mean local CC^2 over the valid windows
    of ``(B, D, H, W, C)`` volumes (C normally 1).

    ``axis_name``: the mesh ``Axis`` of a depth-sharded volume.  Each shard
    takes a ``filter_size // 2``-plane halo, whose windows start at global
    planes ``z0 - hp .. z0 + D_loc - hp`` (the shards tile every start once);
    the starts outside the volume are masked and the masked sum is summed
    over the shards and divided by the global count of valid windows --
    the single-process loss."""
    if axis_name is None:
        return 1.0 - torch.mean(_lncc_cc(input, target, filter_size, 1, 1,
                                         eps))
    k = filter_size
    hp = k // 2
    b, d_loc = input.shape[:2]
    d = d_loc * axis_name.size
    cc = _lncc_cc(halo_exchange_d(input, axis_name, hp),
                  halo_exchange_d(target, axis_name, hp), k, 1, 1, eps)
    g = axis_name.index * d_loc - hp + torch.arange(cc.shape[1],
                                                    device=cc.device)
    mask = ((g >= 0) & (g <= d - k)).to(cc.dtype)[None, :, None, None, None]
    total = b * (d - k + 1) * cc.shape[2] * cc.shape[3] * cc.shape[4]
    return 1.0 - psum((cc * mask).sum(), axis_name) / total


def multiscale_lncc_schedule(img_shape: Sequence[int]):
    """The shape-dependent scale schedule: ``(scales, weights, dilations,
    steps)``."""
    max_scale = min(img_shape)
    if max_scale > 128:
        scales = [max_scale // 16, max_scale // 8, max_scale // 4]
        weights = [0.1, 0.3, 0.6]
        dilations = [2, 2, 2]
    elif max_scale > 64:
        scales = [max_scale // 4, max_scale // 2]
        weights = [0.3, 0.7]
        dilations = [2, 2]
    else:
        scales = [max_scale // 2]
        weights = [1.0]
        dilations = [1]
    steps = [max((s + 1) // 4, 1) for s in scales]
    return scales, weights, dilations, steps


def multiscale_lncc_loss(input: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Multi-scale LNCC with strided, dilated windows."""
    scales, weights, dilations, steps = multiscale_lncc_schedule(
        input.shape[1:4])
    total = 0.0
    for scale, weight, dil, step in zip(scales, weights, dilations, steps):
        cc = _lncc_cc(input, target, scale, step, dil, eps)
        total = total + weight * (1.0 - torch.mean(cc))
    return total
