"""Synthetic corpora written as ``.nii.gz`` files, and the NIfTI-1 writer.

Every array comes from the run's seed, volume by volume, so one seed gives
the same files whatever the thread count.  Files are written by a thread
pool with gzip level 1 (zlib and numpy release the interpreter lock).

* MindBoggle101 layout (``mindboggle/image_in_MNI152_normalized`` and
  ``label_31_reID_merged``, 182 x 218 x 182): a skull-stripped brain, an
  ellipsoid of jittered radii on a zero background, cut by a 4 x 4 x 2 grid
  of jittered blocks labelled 0..31, intensity following the label plus
  noise inside the brain only, so the files compress as real ones do.
* OAI-ZIB layout (``<name>_image.nii.gz`` float32, ``<name>_masks.nii.gz``
  uint8, 160 x 384 x 384): nested ellipsoidal shells labelled 0..4 with
  intensities that follow the labels, plus noise everywhere.
"""
from __future__ import annotations

import gzip
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_CODES = {np.dtype(np.uint8): 2, np.dtype(np.float32): 16}


def write_nifti(path: str, data: np.ndarray, level: int = 1) -> int:
    """Write ``data`` ``(z, y, x)`` as a gzipped NIfTI-1 file with unit
    spacing; returns the bytes written."""
    data = np.ascontiguousarray(data)
    nz, ny, nx = data.shape
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    struct.pack_into("<2h", header, 70, _CODES[data.dtype],
                     data.dtype.itemsize * 8)
    struct.pack_into("<8f", header, 76, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                     1.0)
    struct.pack_into("<3f", header, 108, 352.0, 1.0, 0.0)
    struct.pack_into("<h", header, 254, 1)
    struct.pack_into("<12f", header, 280, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
    header[344:348] = b"n+1\x00"
    blob = gzip.compress(bytes(header) + data.tobytes(), compresslevel=level)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def _rng(seed: int, index: int) -> np.random.Generator:
    return np.random.default_rng([seed, index])


def mindboggle_volume(seed: int, index: int, shape, n_classes: int):
    rng = _rng(seed, index)
    d, h, w = shape
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    radii = rng.uniform(0.82, 0.92, 3).astype(np.float32)
    r2 = ((axes[0][:, None, None] / radii[0]) ** 2
          + (axes[1][None, :, None] / radii[1]) ** 2
          + (axes[2][None, None, :] / radii[2]) ** 2)
    brain = r2 <= 1.0
    index3 = []
    for n, blocks in zip(shape, (4, 4, 2)):
        cuts = (np.arange(1, blocks) / blocks
                + rng.uniform(-0.04, 0.04, blocks - 1)) * n
        index3.append(np.searchsorted(cuts, np.arange(n)))
    seg = ((index3[0][:, None, None] * 4 + index3[1][None, :, None]) * 2
           + index3[2][None, None, :]).astype(np.uint8) % n_classes
    seg = np.where(brain, seg, 0).astype(np.uint8)
    img = (seg.astype(np.float32) + 1) / (n_classes + 1) \
        + np.float32(0.005) * rng.standard_normal(shape, dtype=np.float32)
    img = np.where(brain, img, np.float32(0.0)).astype(np.float32)
    return img, seg


def oai_volume(seed: int, index: int, shape, n_classes: int):
    rng = _rng(seed, index)
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in shape]
    c = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    r = np.sqrt(((axes[0][:, None, None] - c[0]) / 0.9) ** 2
                + ((axes[1][None, :, None] - c[1]) / 0.8) ** 2
                + ((axes[2][None, None, :] - c[2]) / 0.8) ** 2)
    top = n_classes - 1
    seg = np.clip(top - np.floor(r * n_classes), 0, top).astype(np.uint8)
    img = (seg.astype(np.float32) / n_classes + np.float32(0.1)
           + np.float32(0.05) * rng.standard_normal(shape, dtype=np.float32))
    return img, seg


def write_corpus(kind: str, root: str, seed: int, n_volumes: int, shape,
                 n_classes: int, threads: int = 8):
    """Write ``n_volumes`` volumes and masks of ``kind`` (``mindboggle`` or
    ``oai``) under ``root``.  Returns ``(names, arrays, sizes)``: the
    volume names, ``{name: (image, labels)}`` as written, and the bytes of
    each file."""
    make = {"mindboggle": mindboggle_volume, "oai": oai_volume}[kind]
    if kind == "mindboggle":
        img_dir = os.path.join(root, "mindboggle", "image_in_MNI152_normalized")
        seg_dir = os.path.join(root, "mindboggle", "label_31_reID_merged")
        names = [f"mb_{v:03d}" for v in range(n_volumes)]
        paths = [(os.path.join(img_dir, f"{n}.nii.gz"),
                  os.path.join(seg_dir, f"{n}.nii.gz")) for n in names]
    else:
        img_dir = seg_dir = root
        names = [f"oai_{v:03d}_{'LEFT' if v % 2 else 'RIGHT'}"
                 for v in range(n_volumes)]
        paths = [(os.path.join(root, f"{n}_image.nii.gz"),
                  os.path.join(root, f"{n}_masks.nii.gz")) for n in names]
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)

    def one(v):
        img, seg = make(seed, v, tuple(shape), n_classes)
        return img, seg, write_nifti(paths[v][0], img), \
            write_nifti(paths[v][1], seg)

    with ThreadPoolExecutor(threads) as pool:
        done = list(pool.map(one, range(n_volumes)))
    arrays = {n: (img, seg) for n, (img, seg, _, _) in zip(names, done)}
    sizes = {"image": [r[2] for r in done], "labels": [r[3] for r in done]}
    return names, arrays, sizes


def write_list(path: str, names) -> None:
    with open(path, "w") as f:
        f.write("".join(f"{n}\n" for n in names))
