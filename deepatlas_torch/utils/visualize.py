"""Image summaries for TensorBoard (numpy in, numpy out).

Counterpart of ``deepatlas_tpu/utils/visualize.py``, the port's own copy:
mid-slice segmentation summaries (image / truth-overlay / prediction-overlay
rows) and registration summaries (source / warped / target three-plane
slices plus displacement-magnitude panels), with label colors from a fixed
HSV-derived palette alpha-blended over the grayscale slice.

All functions take channel-last arrays and return ``(3, H, W)`` float arrays
in [0, 1] ready for ``ScalarWriter.add_image``; they return the JAX
package's arrays on the same inputs.  ``generate_deform_grid`` and
``plot_grad_flow`` import matplotlib when called.
"""
from __future__ import annotations

import colorsys
from typing import Optional

import numpy as np


def _palette(n: int) -> np.ndarray:
    """n distinct RGB colors (label 0 = black/background)."""
    cols = [(0.0, 0.0, 0.0)]
    for i in range(1, n):
        h = (i * 0.61803398875) % 1.0
        s = 0.85 if i % 2 else 0.6
        v = 0.95 if i % 3 else 0.7
        cols.append(colorsys.hsv_to_rgb(h, s, v))
    return np.asarray(cols, dtype=np.float32)


def labels2colors(labels: np.ndarray, image: Optional[np.ndarray] = None,
                  overlap: bool = False, alpha: float = 0.7,
                  n_labels: Optional[int] = None) -> np.ndarray:
    """Color a 2D label map; optionally alpha-blend over a grayscale image.

    Args:
      labels: (H, W) integer map.
      image: (H, W) grayscale in [0, 1].

    Returns:
      (3, H, W) float RGB.
    """
    labels = np.asarray(labels).astype(np.int32)
    n = n_labels or int(labels.max()) + 1
    pal = _palette(max(n, 2))
    rgb = pal[np.clip(labels, 0, pal.shape[0] - 1)]  # (H, W, 3)
    if overlap:
        if image is None:
            raise ValueError("Need background images when overlap is True")
        img = np.clip(np.asarray(image, dtype=np.float32), 0, 1)
        base = np.repeat(img[..., None], 3, axis=-1)
        fg = labels > 0
        out = base.copy()
        out[fg] = alpha * rgb[fg] + (1 - alpha) * base[fg]
    else:
        out = rgb
    return np.transpose(out, (2, 0, 1))


def _grid(tiles, pad: int = 2, pad_value: float = 1.0) -> np.ndarray:
    """Arrange a list of (3, H, W) tiles in a row."""
    h = max(t.shape[1] for t in tiles)
    w = max(t.shape[2] for t in tiles)
    padded = []
    for t in tiles:
        canvas = np.full((3, h + 2 * pad, w + 2 * pad), pad_value,
                         dtype=np.float32)
        canvas[:, pad:pad + t.shape[1], pad:pad + t.shape[2]] = t
        padded.append(canvas)
    return np.concatenate(padded, axis=2)


def make_segmentation_image_summary(images: np.ndarray, truths: np.ndarray,
                                    logits: np.ndarray, maxoutput: int = 4,
                                    overlap: bool = True,
                                    slice_ind: Optional[int] = None,
                                    alpha: float = 0.7) -> np.ndarray:
    """Mid-slice summary: rows = [image, truth overlay, prediction overlay].

    Args:
      images: (B, D, H, W, C) float volumes.
      truths: (B, D, H, W) integer masks.
      logits: (B, D, H, W, n_classes) raw predictions.
    """
    images = np.asarray(images)
    truths = np.asarray(truths)
    preds = np.argmax(np.asarray(logits), axis=-1)
    if slice_ind is None:
        slice_ind = images.shape[1] // 2
    n = min(maxoutput, images.shape[0])
    n_labels = logits.shape[-1]

    img_tiles, truth_tiles, pred_tiles = [], [], []
    for b in range(n):
        img2d = np.clip(images[b, slice_ind, :, :, 0], 0, 1)
        img_tiles.append(np.repeat(img2d[None], 3, axis=0))
        truth_tiles.append(labels2colors(truths[b, slice_ind], img2d,
                                         overlap, alpha, n_labels))
        pred_tiles.append(labels2colors(preds[b, slice_ind], img2d,
                                        overlap, alpha, n_labels))
    rows = [_grid(img_tiles), _grid(truth_tiles), _grid(pred_tiles)]
    return np.concatenate(rows, axis=1)


def make_registration_image_summary(
        source: np.ndarray, target: np.ndarray, warped: np.ndarray,
        disp_field: np.ndarray, deform_field: np.ndarray,
        source_seg: Optional[np.ndarray] = None,
        target_seg: Optional[np.ndarray] = None,
        warped_source_seg: Optional[np.ndarray] = None,
        n_samples: int = 1) -> dict:
    """Three-plane registration summary.

    Args:
      source/target/warped: (B, D, H, W, C); fields: (B, D, H, W, 3).

    Returns:
      dict of named (3, H, W) image grids: 'images' (source | warped |
      target per plane), 'disp_field' (normalized magnitude per plane),
      optionally 'masks'.
    """
    source = np.asarray(source)
    target = np.asarray(target)
    warped = np.asarray(warped)
    disp = np.asarray(disp_field)
    n = min(n_samples, source.shape[0])
    grids = {}
    image_tiles, disp_tiles, seg_tiles = [], [], []
    for b in range(n):
        for axis in range(3):
            mid = source.shape[axis + 1] // 2
            take = lambda v: np.take(v[b, ..., 0], mid, axis=axis)
            for vol in (source, warped, target):
                sl = np.clip(take(vol), 0, 1)
                image_tiles.append(np.repeat(sl[None], 3, axis=0))
            mag = np.linalg.norm(
                np.take(disp[b], mid, axis=axis), axis=-1)
            mag = mag / (mag.max() + 1e-8)
            disp_tiles.append(np.repeat(mag[None], 3, axis=0))
            if source_seg is not None and target_seg is not None \
                    and warped_source_seg is not None:
                for seg, vol in ((source_seg, source),
                                 (warped_source_seg, warped),
                                 (target_seg, target)):
                    seg_sl = np.take(np.asarray(seg)[b], mid, axis=axis)
                    img_sl = np.clip(take(vol), 0, 1)
                    seg_tiles.append(labels2colors(seg_sl, img_sl, True))
    grids["images"] = _grid(image_tiles)
    grids["disp_field"] = _grid(disp_tiles)
    if seg_tiles:
        grids["masks"] = _grid(seg_tiles)
    return grids


def generate_deform_grid(deform_slice: np.ndarray, background_image:
                         Optional[np.ndarray] = None,
                         n_bins: int = 20) -> np.ndarray:
    """Deformation contour grid over a slice.

    Draws iso-contours of the two in-plane deformation coordinate fields —
    a warped grid visualization of the dense transform.

    Args:
      deform_slice: (H, W, 2) in-plane deformation coordinates in [-1, 1]
        (the two components of the dense deform field along the slice).
      background_image: optional (H, W) grayscale in [0, 1].

    Returns:
      (3, H', W') float RGB in [0, 1].
    """
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    deform_slice = np.asarray(deform_slice)
    h, w = deform_slice.shape[:2]
    fig = Figure(figsize=(w / 20.0, h / 20.0), dpi=20)
    canvas = FigureCanvasAgg(fig)
    ax = fig.add_axes([0, 0, 1, 1], frameon=False)
    ax.set_axis_off()
    if background_image is not None:
        ax.imshow(np.asarray(background_image), vmin=0, vmax=1, cmap="gray")
    levels = np.linspace(-1, 1, n_bins)
    for c in range(deform_slice.shape[-1]):
        ax.contour(deform_slice[..., c], colors=["yellow"], linewidths=2.0,
                   linestyles="solid", levels=levels)
    ax.set_xlim([0, w])
    ax.set_ylim([h, 0])
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].astype(np.float32) / 255.0
    return np.transpose(buf, (2, 0, 1))


def _grad_items(grads):
    """``(name, mean |gradient|)`` pairs: a dict of name -> array or tensor
    in sorted key order (the order a JAX pytree's dict flattens in), or an
    iterable of ``(name, parameter)`` pairs such as
    ``model.named_parameters()`` in its own order, reading each parameter's
    ``.grad`` and skipping those without one."""
    def mean_abs(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.mean(np.abs(np.asarray(v)))

    if isinstance(grads, dict):
        return [(k, mean_abs(grads[k])) for k in sorted(grads)]
    return [(k, mean_abs(p.grad)) for k, p in grads if p.grad is not None]


def plot_grad_flow(grads, max_groups: int = 64) -> np.ndarray:
    """Per-layer mean |gradient| bar chart.

    Args:
      grads: ``model.named_parameters()`` after a backward pass, or a dict
        of name -> gradient (tensor or array); see ``_grad_items``.

    Returns:
      (3, H, W) float RGB image for ``ScalarWriter.add_image``.
    """
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    items = _grad_items(grads)[:max_groups]
    labels = [k for k, _ in items]
    values = [v for _, v in items]

    fig = Figure(figsize=(max(6, len(items) * 0.35), 4), dpi=60)
    canvas = FigureCanvasAgg(fig)
    ax = fig.add_subplot(111)
    ax.bar(range(len(values)), values, color="tab:blue", alpha=0.7)
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=5)
    ax.set_ylabel("mean |grad|")
    ax.set_title("Gradient flow")
    fig.tight_layout()
    canvas.draw()
    buf = np.asarray(canvas.buffer_rgba())[..., :3].astype(np.float32) / 255.0
    return np.transpose(buf, (2, 0, 1))


def slices_padding(slices, pad: int = 2, pad_value: float = 1.0):
    """Pad a list of (3, H, W) slices to a common size: a (N, 3, H', W')
    array."""
    h = max(s.shape[1] for s in slices)
    w = max(s.shape[2] for s in slices)
    out = np.full((len(slices), 3, h, w), pad_value, dtype=np.float32)
    for i, s in enumerate(slices):
        out[i, :, :s.shape[1], :s.shape[2]] = s
    return out
