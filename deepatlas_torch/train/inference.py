"""Whole-volume sliding-window inference (the OAI protocol).

``Partition`` cuts a volume into overlap tiles, the network runs on
fixed-size tile batches (the last chunk zero-padded, so every forward has
the same shape), the per-voxel argmax runs on the device and only uint8
labels return to the host, and ``Partition.assemble`` stitches the tiles
back (center stitch or per-label voting).  Each tile batch's spans:
``tiling.copy_in`` (the upload), ``tiling.predict`` (the network),
``tiling.copy_out`` (the argmax and the labels' copy, which waits on the
network).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.transforms import Partition
from ..metrics.confusion import confusion_matrix, dice_from_confusion
from ..utils.profiling import annotate


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_tile_predictor(model: torch.nn.Module, tile_batch: int = 4
                        ) -> Callable[[np.ndarray], np.ndarray]:
    """Returns ``tiles (N, d, h, w, 1) -> labels (N, d, h, w) uint8``
    running ``model`` (eval mode, on its parameters' device) on chunks of
    ``tile_batch`` tiles."""
    device = _model_device(model)

    def predict(tiles: np.ndarray) -> np.ndarray:
        n = tiles.shape[0]
        pad = (-n) % tile_batch
        if pad:
            tiles = np.concatenate(
                [tiles, np.zeros((pad,) + tiles.shape[1:], tiles.dtype)])
        outs = []
        with torch.inference_mode():
            for i in range(0, tiles.shape[0], tile_batch):
                with annotate("tiling.copy_in"):
                    x = torch.from_numpy(np.ascontiguousarray(
                        tiles[i:i + tile_batch])).to(device)
                with annotate("tiling.predict"):
                    logits = model(x, train=False)
                with annotate("tiling.copy_out"):
                    outs.append(logits.argmax(dim=-1).to(torch.uint8).cpu()
                                .numpy())
        return np.concatenate(outs)[:n]

    return predict


def sliding_window_predict(predict_tiles: Callable, sample: dict,
                           tile_size: Sequence[int],
                           overlap_size: Sequence[int],
                           is_vote: bool = False,
                           crop_size: Optional[Sequence[int]] = None,
                           padding_mode: str = "reflect") -> np.ndarray:
    """Partition ``sample['image']`` (``(D, H, W, 1)`` float32) into
    overlap tiles, predict labels per tile, and reassemble.

    Returns ``(D, H, W)`` uint8 labels.
    """
    part = Partition(tile_size, overlap_size, padding_mode=padding_mode)
    tiled = part(dict(sample))
    labels = predict_tiles(tiled["image"])
    return part.assemble(labels, is_vote=is_vote, crop_size=crop_size,
                         data_type=np.uint8)


def volume_dice(pred: np.ndarray, truth: np.ndarray, n_classes: int,
                device: torch.device) -> np.ndarray:
    """Foreground per-class dice (classes 1..n-1) of one volume, computed
    on ``device``."""
    cm = confusion_matrix(torch.tensor(np.asarray(pred), device=device),
                          torch.tensor(np.asarray(truth), device=device),
                          n_classes)
    return dice_from_confusion(cm, 1e-11)[1:].cpu().numpy()


def evaluate_sliding_window(model: torch.nn.Module, dataloader,
                            tile_size, overlap_size, n_classes: int,
                            tile_batch: int = 4, is_vote: bool = False):
    """Sliding-window evaluation over a dataset: per-class dice of the
    assembled whole-volume predictions, and the volume names."""
    predict = make_tile_predictor(model, tile_batch)
    device = _model_device(model)
    dices = []
    names = []
    for batch in dataloader:
        for b in range(batch["image"].shape[0]):
            pred = sliding_window_predict(predict, {"image": batch["image"][b]},
                                          tile_size, overlap_size,
                                          is_vote=is_vote)
            dices.append(volume_dice(pred, batch["segmentation"][b],
                                     n_classes, device))
            names.append(batch["name"][b])
    return np.stack(dices), names
