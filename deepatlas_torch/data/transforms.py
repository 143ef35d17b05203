"""Host-side data transforms (numpy).

Arrays are in ``(z, y, x)`` = (D, H, W) index order with channel-last
images, as in ``deepatlas_tpu.data.transforms``:

  * ``VolumeToArray`` -- clamp the image to [0, 1] float32 with a trailing
    channel axis; segmentation to uint8.
  * ``LeftToRight``   -- OAI left-knee flip.
  * ``CropVolume``    -- border crop (the MindBoggle training recipe).
  * ``PadVolume``     -- pad to a target (D, H, W) shape.
  * ``SegmentationLabelFilter`` -- label zeroing.
  * ``RandomCrop`` / ``BalancedRandomCrop`` -- OAI patch sampling (a
    random ROI above a foreground fraction; class-targeted ROIs in turn).
  * ``Resample``      -- resample to a target voxel size (image trilinear,
    labels nearest-neighbour) through the native tier.
  * ``Normalization`` -- zero-mean / unit-variance image, native tier.
  * ``BilateralFilter`` -- edge-preserving smoothing with probability
    ``ratio``, native tier.
  * ``Partition``     -- overlap-tile partition + ``assemble`` (center
    stitch or per-label voting) for sliding-window inference.
  * ``Compose`` / ``IdentityTransform``.

The three native-tier transforms call ``_native.py`` (the C++ library of
``native/deepatlas_io.cpp``) and keep the JAX package's numpy fallbacks for
where the library is not built.

Samples flow as dicts {'image': (D,H,W,1) float32, 'segmentation': (D,H,W)
uint8, 'name': str, ['spacing': (sx,sy,sz), 'like': NiftiImage]}.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np

from ..utils.profiling import annotate
from .nifti import NiftiImage


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class IdentityTransform:
    def __call__(self, sample):
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


class PadVolume:
    """Pad spatial dims of a ``(D, H, W, C)`` image and its segmentation up
    to a target (D, H, W) shape, the extra split evenly (the odd voxel
    after); the image pads with ``mode``, the segmentation with 0."""

    def __init__(self, target_shape: Sequence[int], mode: str = "constant"):
        self.target = tuple(target_shape)
        self.mode = mode

    def __call__(self, sample):
        img = sample["image"]
        pads = []
        for axis in range(3):
            extra = self.target[axis] - img.shape[axis]
            if extra < 0:
                raise ValueError(
                    f"PadVolume target {self.target} smaller than volume "
                    f"{img.shape[:3]}")
            pads.append((extra // 2, extra - extra // 2))
        sample["image"] = np.pad(img, pads + [(0, 0)], mode=self.mode)
        if sample.get("segmentation") is not None:
            sample["segmentation"] = np.pad(sample["segmentation"], pads,
                                            mode="constant")
        return sample


class SegmentationLabelFilter:
    """Set the listed labels of the segmentation to 0."""

    def __init__(self, ignore_labels: Sequence[int]):
        self.ignore_labels = list(ignore_labels)

    def __call__(self, sample):
        seg = sample.get("segmentation")
        if seg is not None:
            seg = seg.copy()
            for label in self.ignore_labels:
                seg[seg == label] = 0
            sample["segmentation"] = seg
        return sample


def _rand_start(rng, extent):
    """A crop's start on one axis: ``randint(0, extent)``, so the last
    start position ``extent`` itself is never drawn."""
    return rng.randint(0, extent) if extent > 0 else 0


class RandomCrop:
    """Random ROI crop of ``output_size`` (D, H, W) whose foreground
    fraction (labels summed over the crop's voxels) exceeds ``threshold``.

    At most ``max_tries`` draws from ``random_state`` (a
    ``np.random.RandomState``); after that the last crop is returned even
    if it is below the threshold."""

    def __init__(self, output_size: Union[int, Sequence[int]],
                 threshold: float = 0.0, random_state=None,
                 max_tries: int = 100):
        if isinstance(output_size, int):
            output_size = (output_size,) * 3
        self.size = tuple(output_size)
        self.threshold = threshold
        self.rng = random_state or np.random.RandomState()
        self.max_tries = max_tries

    def _crop_at(self, sample, start):
        sl = tuple(slice(s, s + n) for s, n in zip(start, self.size))
        out = dict(sample)
        out["image"] = sample["image"][sl]
        if sample.get("segmentation") is not None:
            out["segmentation"] = sample["segmentation"][sl]
        return out

    def __call__(self, sample):
        img = sample["image"]
        extent = [img.shape[i] - self.size[i] for i in range(3)]
        for _ in range(self.max_tries):
            start = [_rand_start(self.rng, e) for e in extent]
            out = self._crop_at(sample, start)
            seg = out.get("segmentation")
            if seg is None or self.threshold <= 0:
                return out
            if seg.sum() / seg.size > self.threshold:
                return out
        return out


class BalancedRandomCrop(RandomCrop):
    """Class-targeted ROI crops in turn: each call targets one class and
    draws until that class's fraction of the crop exceeds its threshold
    (at most ``max_tries`` draws; class 0 takes the first draw), then sets
    ``out["class"]`` and moves on.  The target starts at ``min(2,
    n_classes - 1)`` and cycles through ``0..n_classes`` inclusive: class
    ``n_classes``, in no mask, spends all its tries.  A float ``threshold``
    applies to every class.  The target advances without a lock, so
    loader threads sharing one sampler draw in the order they run."""

    def __init__(self, output_size, threshold=0.01, n_classes: int = 3,
                 random_state=None, max_tries: int = 100):
        super().__init__(output_size, 0.0, random_state, max_tries)
        if isinstance(threshold, float):
            threshold = (threshold,) * n_classes
        self.thresholds = tuple(threshold)
        self.n_classes = n_classes
        self.current_class = min(2, n_classes - 1)

    def __call__(self, sample):
        img = sample["image"]
        extent = [img.shape[i] - self.size[i] for i in range(3)]
        target = self.current_class
        out = None
        for _ in range(self.max_tries):
            start = [_rand_start(self.rng, e) for e in extent]
            out = self._crop_at(sample, start)
            seg = out.get("segmentation")
            if seg is None or target == 0:
                break
            frac = np.mean(seg == target)
            if frac > self.thresholds[min(target, len(self.thresholds) - 1)]:
                break
        out["class"] = target
        self.current_class += 1
        if self.current_class > self.n_classes:
            self.current_class = 0
        return out


class Resample:
    """Resample image and segmentation to a target voxel size.

    Output size per axis is ``ceil(old_spacing * old_size / new_spacing)``.
    The image resamples trilinearly at the target voxels' centres, the
    segmentation nearest-neighbour (``seg_interpolator="linear"`` resamples
    it trilinearly and rounds, as the original reference did), both
    through the native tier with numpy fallbacks.  Runs on the numpy
    ``(D, H, W[, 1])`` arrays and the ``spacing`` key (``(sx, sy, sz)``)
    that ``VolumeToArray`` records, so compose it after ``VolumeToArray``.
    """

    def __init__(self, voxel_size, seg_interpolator: str = "nearest"):
        if isinstance(voxel_size, (int, float)):
            voxel_size = (float(voxel_size),) * 3
        if len(voxel_size) != 3:
            raise ValueError("voxel_size must be a float or 3-tuple")
        self.voxel_size = tuple(float(v) for v in voxel_size)  # (sx, sy, sz)
        if seg_interpolator not in ("nearest", "linear"):
            raise ValueError("seg_interpolator must be nearest|linear")
        self.seg_interpolator = seg_interpolator

    @staticmethod
    def _trilinear(vol, out_shape):
        from ._native import resample_trilinear_native
        out = resample_trilinear_native(vol, out_shape)
        if out is not None:
            return out
        # numpy fallback: sample target voxel centers in the source grid
        sz, sy, sx = vol.shape
        dz, dy, dx = out_shape
        zc = (np.arange(dz) + 0.5) * (sz / dz) - 0.5
        yc = (np.arange(dy) + 0.5) * (sy / dy) - 0.5
        xc = (np.arange(dx) + 0.5) * (sx / dx) - 0.5

        def axis_idx(c, n):
            i0 = np.floor(c).astype(np.int64)
            t = c - i0
            return (np.clip(i0, 0, n - 1), np.clip(i0 + 1, 0, n - 1),
                    t.astype(np.float32))

        z0, z1, tz = axis_idx(zc, sz)
        y0, y1, ty = axis_idx(yc, sy)
        x0, x1, tx = axis_idx(xc, sx)
        v = vol
        c00 = v[z0][:, y0][:, :, x0] * (1 - tx) + v[z0][:, y0][:, :, x1] * tx
        c01 = v[z0][:, y1][:, :, x0] * (1 - tx) + v[z0][:, y1][:, :, x1] * tx
        c10 = v[z1][:, y0][:, :, x0] * (1 - tx) + v[z1][:, y0][:, :, x1] * tx
        c11 = v[z1][:, y1][:, :, x0] * (1 - tx) + v[z1][:, y1][:, :, x1] * tx
        c0 = c00 * (1 - ty[None, :, None]) + c01 * ty[None, :, None]
        c1 = c10 * (1 - ty[None, :, None]) + c11 * ty[None, :, None]
        return (c0 * (1 - tz[:, None, None])
                + c1 * tz[:, None, None]).astype(np.float32)

    @staticmethod
    def _nearest(vol, out_shape):
        from ._native import resample_nearest_native
        out = resample_nearest_native(vol, out_shape)
        if out is not None:
            return out
        sz, sy, sx = vol.shape
        dz, dy, dx = out_shape

        def axis_idx(n_out, n):
            return np.clip(np.floor((np.arange(n_out) + 0.5) * (n / n_out))
                           .astype(np.int64), 0, n - 1)

        return vol[axis_idx(dz, sz)][:, axis_idx(dy, sy)][
            :, :, axis_idx(dx, sx)]

    def __call__(self, sample):
        spacing = sample.get("spacing", (1.0, 1.0, 1.0))  # (sx, sy, sz)
        img = sample["image"]
        squeeze = img.ndim == 4
        vol = img[..., 0] if squeeze else img            # (D, H, W)
        sz, sy, sx = vol.shape
        # sizes are (x, y, z) in sitk convention; arrays are (z, y, x)
        out_shape = tuple(
            int(math.ceil(spacing[a] * n / self.voxel_size[a]))
            for a, n in ((2, sz), (1, sy), (0, sx)))
        out = self._trilinear(np.asarray(vol, np.float32), out_shape)
        sample["image"] = out[..., None] if squeeze else out
        sample["spacing"] = self.voxel_size
        seg = sample.get("segmentation")
        if seg is not None:
            seg_f = np.asarray(seg, np.float32)
            if self.seg_interpolator == "nearest":
                res = self._nearest(seg_f, out_shape)
            else:
                res = self._trilinear(seg_f, out_shape)
            sample["segmentation"] = np.rint(res).astype(seg.dtype)
        return sample


class Normalization:
    """Zero-mean / unit-variance intensity normalisation of the image,
    through the native tier (numpy fallback)."""

    def __call__(self, sample):
        from ._native import normalize_native

        img = np.asarray(sample["image"], np.float32)
        out = normalize_native(img.reshape(-1), clamp01=False)
        if out is not None:
            sample["image"] = out.reshape(img.shape)
        else:
            mu = float(img.mean())
            sd = float(img.std())
            sample["image"] = (img - mu) / (sd + 1e-12)
        return sample


class BilateralFilter:
    """Edge-preserving bilateral smoothing of the image with probability
    ``ratio``: one ``rng.rand(1)`` draw per call decides.

    ``domain_sigma`` is the spatial gaussian sigma in voxels (a window of
    radius ``ceil(2.5 sigma)``), ``range_sigma`` the intensity gaussian
    sigma; the native tier evaluates the range gaussian through a lookup
    table of ``n_range_samples`` samples (ITK's
    numberOfRangeGaussianSamples), the numpy fallback exactly.
    """

    def __init__(self, domain_sigma: float = 0.5, range_sigma: float = 0.06,
                 n_range_samples: int = 50, ratio: float = 1.0,
                 rng: Optional[np.random.RandomState] = None):
        self.domain_sigma = domain_sigma
        self.range_sigma = range_sigma
        self.n_range_samples = n_range_samples
        self.ratio = ratio
        self.rng = rng or np.random

    def _filter(self, vol):
        from ._native import bilateral_native

        out = bilateral_native(vol, self.domain_sigma, self.range_sigma,
                               self.n_range_samples)
        if out is not None:
            return out
        # numpy fallback (small volumes / no toolchain): brute-force window
        r = max(int(np.ceil(2.5 * self.domain_sigma)), 1)
        pad = np.pad(vol, r, mode="edge")
        num = np.zeros_like(vol)
        den = np.zeros_like(vol)
        inv_d = 1.0 / (2 * self.domain_sigma ** 2)
        inv_r = 1.0 / (2 * self.range_sigma ** 2)
        sz, sy, sx = vol.shape
        for dz in range(-r, r + 1):
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    sw = np.exp(-(dz * dz + dy * dy + dx * dx) * inv_d)
                    nb = pad[r + dz:r + dz + sz, r + dy:r + dy + sy,
                             r + dx:r + dx + sx]
                    wgt = sw * np.exp(-(nb - vol) ** 2 * inv_r)
                    num += wgt * nb
                    den += wgt
        return (num / np.maximum(den, 1e-12)).astype(np.float32)

    def __call__(self, sample):
        if float(self.rng.rand(1)[0]) >= self.ratio:
            return sample
        img = sample["image"]
        squeeze = img.ndim == 4
        vol = np.asarray(img[..., 0] if squeeze else img, np.float32)
        out = self._filter(vol)
        sample["image"] = out[..., None] if squeeze else out
        return sample


class Partition:
    """Overlap-tile partition of a volume for sliding-window inference.

    ``tile_size`` / ``overlap_size`` are (D, H, W).  ``__call__`` pads the
    volume (reflect) to a whole tile grid and returns the stacked tiles;
    ``assemble`` reassembles per-tile predictions, either by stitching the
    effective (non-overlap) centers or by per-label voting.  Spans:
    ``tiling.pad`` (the padding), ``tiling.cut`` (the tiles and their
    float32 copy), ``tiling.stitch`` (``assemble``).
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
        with annotate("tiling.pad"):
            img_padded = np.pad(img, pad, mode=self.padding_mode)
        with annotate("tiling.cut"):
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
        with annotate("tiling.stitch"):
            return self._assemble(np.asarray(tiles), is_vote, crop_size,
                                  data_type)

    def _assemble(self, tiles, is_vote, crop_size, data_type):
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
