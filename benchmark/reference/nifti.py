"""A plain NIfTI-1 reader: gzip from the standard library, little- or
big-endian headers, voxels in the file's type scaled by ``scl_slope`` /
``scl_inter``, returned in ``(z, y, x)`` index order."""
from __future__ import annotations

import gzip
import struct

import numpy as np

_TYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
          64: np.float64, 256: np.int8, 512: np.uint16}


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    bo = "<" if struct.unpack_from("<i", raw, 0)[0] == 348 else ">"
    if struct.unpack_from(bo + "i", raw, 0)[0] != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file")
    dim = struct.unpack_from(bo + "8h", raw, 40)
    code = struct.unpack_from(bo + "h", raw, 70)[0]
    offset = int(struct.unpack_from(bo + "f", raw, 108)[0])
    slope, inter = struct.unpack_from(bo + "2f", raw, 112)
    nx, ny, nz = (max(1, dim[i]) for i in (1, 2, 3))
    dtype = np.dtype(_TYPES[code]).newbyteorder(bo)
    arr = np.frombuffer(raw, dtype, nx * ny * nz, offset).reshape(nz, ny, nx)
    arr = arr.astype(dtype.newbyteorder("="))
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr.astype(np.float32) * (slope or 1.0) + inter
    return arr
