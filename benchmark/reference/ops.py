"""Plain warps and losses of the DeepAtlas recipes, channels-first.

The warp is ``F.grid_sample`` (trilinear, zeros outside, align_corners) at
a deformation ``(B, D, H, W, 3)`` whose last axis is ``(x, y, z)`` in
normalized ``[-1, 1]`` units, each axis of its displacement clamped to
+-``max_disp`` voxels first.  The losses follow the recipes: the softmax
dice of ``train_seg.py`` (Uniform weights, background kept, eps 1e-6), the
anatomy's soft dice over the foreground (eps 1e-5), VoxelMorph's LNCC over
9^3 windows (eps 1e-6) and the bending energy with side-normalized scale
factors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def identity_grid(shape, device) -> torch.Tensor:
    """``(1, D, H, W, 3)``: voxel ``i`` of an axis of ``n`` at
    ``-1 + 2 i / (n - 1)``, last axis ``(x, y, z)``."""
    d, h, w = shape
    z, y, x = torch.meshgrid(
        *(torch.linspace(-1.0, 1.0, n, device=device) for n in (d, h, w)),
        indexing="ij")
    return torch.stack([x, y, z], dim=-1)[None]


def clamped_deformation(disp: torch.Tensor, max_disp) -> torch.Tensor:
    """``identity + clamp(disp)`` with each axis bounded to ``max_disp``
    voxels (no bound for None)."""
    shape = disp.shape[1:4]
    ident = identity_grid(shape, disp.device)
    if max_disp is None:
        return ident + disp
    d, h, w = shape
    bound = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1), 2.0 / (d - 1)],
                         device=disp.device) * max_disp
    return ident + torch.maximum(torch.minimum(disp, bound), -bound)


def warp(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def one_hot(labels: torch.Tensor, n_class: int) -> torch.Tensor:
    """``(B, D, H, W)`` integer labels as ``(B, C, D, H, W)`` float32."""
    return F.one_hot(labels.long(), n_class).permute(0, 4, 1, 2, 3).float()


def dice_loss(logits, labels, n_class, eps=1e-6) -> torch.Tensor:
    """``train_seg.py``'s loss: softmax probabilities against the one-hot,
    scores ``(2 I + eps) / (S + T + 2 eps)`` per batch element and class,
    uniform weights."""
    probs = torch.softmax(logits, dim=1)
    tgt = one_hot(labels, n_class)
    dims = (2, 3, 4)
    inter = (probs * tgt).sum(dims)
    score = (2 * inter + eps) / (probs.sum(dims) + tgt.sum(dims) + 2 * eps)
    return 1.0 - score.mean()


def soft_dice(src, tgt, eps=1e-5) -> torch.Tensor:
    """1 - mean foreground dice of two ``(B, C, D, H, W)`` probability
    volumes."""
    dims = (2, 3, 4)
    s, t = src[:, 1:], tgt[:, 1:]
    return 1.0 - (2.0 * (s * t).sum(dims)
                  / (s.sum(dims) + t.sum(dims) + eps)).mean()


def lncc_loss(i_img, j_img, window=9, eps=1e-6) -> torch.Tensor:
    """1 - mean squared local correlation over the valid ``window``^3
    windows of ``(B, 1, D, H, W)`` volumes."""
    n = float(window ** 3)

    def wsum(x):
        return F.avg_pool3d(x, window, stride=1) * n

    i_sum, j_sum = wsum(i_img), wsum(j_img)
    i2, j2, ij = wsum(i_img * i_img), wsum(j_img * j_img), wsum(i_img * j_img)
    i_mean, j_mean = i_sum / n, j_sum / n
    cross = ij - i_mean * j_sum - j_mean * i_sum + i_mean * j_mean * n
    i_var = i2 - 2 * i_mean * i_sum + i_mean ** 2 * n
    j_var = j2 - 2 * j_mean * j_sum + j_mean ** 2 * n
    return 1.0 - torch.mean(cross ** 2 / (i_var * j_var + eps))


def bending_energy(field: torch.Tensor) -> torch.Tensor:
    """Mean squared second differences of ``(B, D, H, W, 3)`` over the
    interior: three pure and three mixed (counted twice), component ``k``
    scaled by the square of the ``k``-th side over the shortest, over 9."""
    b, c = field.shape[0], field.shape[-1]
    dims = torch.tensor([float(n) for n in field.shape[1:4]],
                        device=field.device)
    scale = (dims / dims.min()) ** 2
    f = field
    inner = f[:, 1:-1, 1:-1, 1:-1]

    def term(x):
        return (x ** 2).reshape(b, -1, c).mean(dim=1) * scale

    pure = [f[:, 2:, 1:-1, 1:-1] + f[:, :-2, 1:-1, 1:-1] - 2 * inner,
            f[:, 1:-1, 2:, 1:-1] + f[:, 1:-1, :-2, 1:-1] - 2 * inner,
            f[:, 1:-1, 1:-1, 2:] + f[:, 1:-1, 1:-1, :-2] - 2 * inner]
    mixed = [f[:, 2:, 2:, 1:-1] + f[:, :-2, :-2, 1:-1]
             - f[:, 2:, :-2, 1:-1] - f[:, :-2, 2:, 1:-1],
             f[:, 1:-1, 2:, 2:] + f[:, 1:-1, :-2, :-2]
             - f[:, 1:-1, 2:, :-2] - f[:, 1:-1, :-2, 2:],
             f[:, 2:, 1:-1, 2:] + f[:, :-2, 1:-1, :-2]
             - f[:, 2:, 1:-1, :-2] - f[:, :-2, 1:-1, 2:]]
    total = sum(term(x).mean() for x in pure) \
        + 2 * sum(term(x).mean() for x in mixed)
    return total / 9.0
