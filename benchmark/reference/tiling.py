"""Plain sliding-window serving: ``infer_seg.py``'s overlap tiles and
centre stitch (uncbiag/DeepAtlas ``lib/transforms.py`` ``Partition``).

The volume is reflect-padded by ``overlap`` in front and up to a whole grid
of ``tile - 2 overlap`` steps behind, cut into tiles in (D, H, W) raster
order, and each tile's centre (the tile less ``overlap`` on each side) is
written back; the result is cropped to the volume.  Here the stitched
quantity is the float32 logits, so that a served label can be judged by
how far its logit lies below the best one.
"""
from __future__ import annotations

import numpy as np
import torch

from . import nets
from .precision import Precision


def tile_grid(size, tile, overlap):
    size, tile, overlap = (np.asarray(v, int) for v in (size, tile, overlap))
    eff = tile - 2 * overlap
    grid = -(-size // eff)
    pad_hi = eff * grid + 2 * overlap - size - overlap
    return eff, grid, [(int(o), int(p)) for o, p in zip(overlap, pad_hi)]


def stitched_logits(config, params, stats, image: np.ndarray, device,
                    prec: Precision, tile_batch: int) -> torch.Tensor:
    """``(C, D, H, W)`` float32 logits of ``image`` ``(D, H, W)`` stitched
    from the centres of its overlap tiles."""
    tile, overlap = config["tile"], config["overlap"]
    eff, grid, pad = tile_grid(image.shape, tile, overlap)
    padded = torch.from_numpy(np.pad(image, pad, mode="reflect")).to(device)
    starts = [(i * eff[0], j * eff[1], k * eff[2])
              for i in range(grid[0]) for j in range(grid[1])
              for k in range(grid[2])]
    out = torch.zeros((config["n_classes"],) + tuple(eff * grid),
                      device=device)
    o = overlap
    for b in range(0, len(starts), tile_batch):
        chunk = starts[b:b + tile_batch]
        x = torch.stack([padded[z:z + tile[0], y:y + tile[1],
                                w:w + tile[2]] for z, y, w in chunk])
        with torch.no_grad():
            logits = nets.unet_forward(config, params, stats, x[:, None],
                                       False, prec)
        for (z, y, w), lg in zip(chunk, logits):
            out[:, z:z + eff[0], y:y + eff[1], w:w + eff[2]] = \
                lg[:, o[0]:tile[0] - o[0], o[1]:tile[1] - o[1],
                   o[2]:tile[2] - o[2]]
    d, h, w = image.shape
    return out[:, :d, :h, :w]


def label_gap(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """The widest gap by which a label's logit lies below the best logit of
    its voxel."""
    best = logits.max(dim=0).values
    got = logits.gather(0, labels.long()[None])[0]
    return float((best - got).max())


def label_gap_mean(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """The mean over voxels of the gap by which a label's logit lies below
    the best logit of its voxel."""
    best = logits.max(dim=0).values
    got = logits.gather(0, labels.long()[None])[0]
    return float((best - got).double().mean())


def label_flip_share(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """The share of voxels whose label is not the one with the best
    logit."""
    return float((logits.argmax(dim=0) != labels.long()).double().mean())


def dice(pred: np.ndarray, truth: np.ndarray, n_class: int) -> np.ndarray:
    """Foreground per-class dice ``2 |P n T| / (|P| + |T|)`` in float64
    (a class absent from both scores 0)."""
    out = np.zeros(n_class - 1)
    for c in range(1, n_class):
        p, t = pred == c, truth == c
        denom = float(p.sum()) + float(t.sum())
        out[c - 1] = 2.0 * float((p & t).sum()) / denom if denom else 0.0
    return out
