"""Host-side data transforms (numpy).

Arrays are in ``(z, y, x)`` = (D, H, W) index order with channel-last
images, as in ``deepatlas_tpu.data.transforms``:

  * ``VolumeToArray`` -- clamp the image to [0, 1] float32 with a trailing
    channel axis; segmentation to uint8.
  * ``LeftToRight``   -- OAI left-knee flip.
  * ``CropVolume``    -- border crop (the MindBoggle training recipe).
  * ``Partition``     -- overlap-tile partition + ``assemble`` (center
    stitch or per-label voting) for sliding-window inference.
  * ``Compose``.

Samples flow as dicts {'image': (D,H,W,1) float32, 'segmentation': (D,H,W)
uint8, 'name': str, ['spacing': (sx,sy,sz), 'like': NiftiImage]}.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .nifti import NiftiImage


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class VolumeToArray:
    """NiftiImage -> numpy arrays; image clamped to [0, 1] float32 with a
    trailing channel axis, segmentation to uint8."""

    def __call__(self, sample):
        img = sample["image"]
        if isinstance(img, NiftiImage):
            sample["spacing"] = img.spacing
            sample["like"] = img
            img = img.data
        img = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
        if img.ndim == 3:
            img = img[..., None]
        sample["image"] = img
        if sample.get("segmentation") is not None:
            seg = sample["segmentation"]
            if isinstance(seg, NiftiImage):
                seg = seg.data
            sample["segmentation"] = np.asarray(seg, dtype=np.uint8)
        return sample


class LeftToRight:
    """Flip LEFT-side scans along the first axis (OAI knees)."""

    def __call__(self, sample):
        if "LEFT" in sample.get("name", ""):
            sample["image"] = np.flip(sample["image"], axis=0).copy()
            seg = sample.get("segmentation")
            if seg is not None:
                sample["segmentation"] = np.flip(seg, axis=0).copy()
        return sample


class CropVolume:
    """Crop borders; ``crop_size`` is (d, h, w) symmetric or
    (d_lo, h_lo, w_lo, d_hi, h_hi, w_hi)."""

    def __init__(self, crop_size: Sequence[int]):
        crop_size = list(crop_size)
        if len(crop_size) == 3:
            self.crop = crop_size + crop_size
        elif len(crop_size) == 6:
            self.crop = crop_size
        else:
            raise ValueError("crop size should be of length 3 or 6, but "
                             f"{len(crop_size)} is given")

    def __call__(self, sample):
        c = self.crop
        img = sample["image"]
        d, h, w = img.shape[:3]
        sl = (slice(c[0], d - c[3]), slice(c[1], h - c[4]),
              slice(c[2], w - c[5]))
        sample["image"] = img[sl]
        if sample.get("segmentation") is not None:
            sample["segmentation"] = sample["segmentation"][sl]
        return sample


class Partition:
    """Overlap-tile partition of a volume for sliding-window inference.

    ``tile_size`` / ``overlap_size`` are (D, H, W).  ``__call__`` pads the
    volume (reflect) to a whole tile grid and returns the stacked tiles;
    ``assemble`` reassembles per-tile predictions, either by stitching the
    effective (non-overlap) centers or by per-label voting.
    """

    def __init__(self, tile_size: Sequence[int], overlap_size: Sequence[int],
                 padding_mode: str = "reflect"):
        self.tile_size = np.asarray(tile_size, dtype=int)
        self.overlap_size = np.asarray(overlap_size, dtype=int)
        self.padding_mode = padding_mode

    def __call__(self, sample):
        image = sample["image"]
        img = image[..., 0] if image.ndim == 4 else image
        self.image_size = np.array(img.shape)
        self.effective_size = self.tile_size - self.overlap_size * 2
        self.tiles_grid_size = np.ceil(
            self.image_size / self.effective_size).astype(int)
        self.padded_size = (self.effective_size * self.tiles_grid_size
                            + self.overlap_size * 2 - self.image_size)

        pad = [(int(self.overlap_size[i]),
                int(self.padded_size[i] - self.overlap_size[i]))
               for i in range(3)]
        img_padded = np.pad(img, pad, mode=self.padding_mode)

        tiles = self._extract_tiles(img_padded, self.tile_size)
        sample = dict(sample)
        sample["image"] = tiles[..., None].astype(np.float32)
        return sample

    def _extract_tiles(self, padded, tile_size):
        g = self.tiles_grid_size
        e = self.effective_size
        tiles = []
        for i in range(g[0]):
            for j in range(g[1]):
                for k in range(g[2]):
                    tiles.append(padded[
                        i * e[0]:i * e[0] + tile_size[0],
                        j * e[1]:j * e[1] + tile_size[1],
                        k * e[2]:k * e[2] + tile_size[2]])
        return np.stack(tiles, axis=0)

    def assemble(self, tiles: np.ndarray, is_vote: bool = False,
                 crop_size: Optional[Sequence[int]] = None,
                 data_type=None):
        """Reassemble per-tile label predictions to the original volume.

        Args:
          tiles: ``(N, D, H, W)`` predicted label tiles (tile order from
            ``__call__``).
          is_vote: per-voxel, per-label voting over overlapping tiles
            instead of center stitching.
          crop_size: optional (h, w, d)-style border zeroing (the original
            reference's crop_size axis order).
        """
        tiles = np.asarray(tiles)
        g = self.tiles_grid_size
        e = self.effective_size
        o = self.overlap_size
        t = self.tile_size

        if is_vote:
            labels = np.unique(tiles)
            full = e * g + o * 2
            votes = np.zeros((labels.size,) + tuple(full), dtype=np.int32)
            for i in range(g[0]):
                for j in range(g[1]):
                    for k in range(g[2]):
                        tile = tiles[(i * g[1] + j) * g[2] + k]
                        region = votes[:, i * e[0]:i * e[0] + t[0],
                                       j * e[1]:j * e[1] + t[1],
                                       k * e[2]:k * e[2] + t[2]]
                        for li, label in enumerate(labels):
                            region[li] += tile == label
            # the winning *index* maps back through `labels`
            win = np.argmax(votes, axis=0)
            out = labels[win][o[0]:o[0] + self.image_size[0],
                              o[1]:o[1] + self.image_size[1],
                              o[2]:o[2] + self.image_size[2]].astype(np.uint8)
        else:
            out = np.zeros(tuple(e * g), dtype=tiles.dtype)
            for i in range(g[0]):
                for j in range(g[1]):
                    for k in range(g[2]):
                        out[i * e[0]:(i + 1) * e[0],
                            j * e[1]:(j + 1) * e[1],
                            k * e[2]:(k + 1) * e[2]] = \
                            tiles[(i * g[1] + j) * g[2] + k][
                                o[0]:t[0] - o[0],
                                o[1]:t[1] - o[1],
                                o[2]:t[2] - o[2]]
            out = out[:self.image_size[0], :self.image_size[1],
                      :self.image_size[2]]

        if data_type is not None:
            out = out.astype(data_type)
        if crop_size:
            cropped = np.zeros_like(out)
            cz, cx, cy = crop_size[2], crop_size[0], crop_size[1]
            cropped[cz:-cz or None, cx:-cx or None, cy:-cy or None] = \
                out[cz:-cz or None, cx:-cx or None, cy:-cy or None]
            out = cropped
        return out
