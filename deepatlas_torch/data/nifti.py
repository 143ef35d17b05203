"""Self-contained NIfTI-1 reader/writer (numpy, gzip via stdlib) over the
native I/O tier.

Arrays are returned in ``(z, y, x)`` index order, matching
``sitk.GetArrayFromImage`` as the original reference used, so every
downstream shape convention carries over.  ``read_nifti`` reads through the
native C++ library (``_native.py``: zlib inflate and dtype conversion in
C++, float32 voxels) and falls back to the Python parser where the library
is not built or cannot decode the file, as ``deepatlas_tpu.data.nifti``
does; ``read_counts`` says which path each read took.  ``write_nifti`` is
the Python writer (the JAX package's writer has no native path either).
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    """A loaded NIfTI volume.

    Attributes:
      data: ``(z, y, x)`` voxel array (sitk array convention).
      spacing: ``(sx, sy, sz)`` voxel size in mm (sitk convention: x first).
      affine: 4x4 voxel->world matrix (sform if present).
    """
    data: np.ndarray
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    affine: Optional[np.ndarray] = None

    def copy_information(self, other: "NiftiImage") -> "NiftiImage":
        """Attach geometry from another image (sitk CopyInformation)."""
        self.spacing = other.spacing
        self.affine = None if other.affine is None else other.affine.copy()
        return self


def _open_maybe_gzip(path: Union[str, Path], mode: str):
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


_counts_lock = threading.Lock()
_counts = {"native": 0, "fallback": 0}


def read_counts() -> dict:
    """Reads since the last reset: ``native`` through the C++ library,
    ``fallback`` through the Python parser after a native attempt that
    returned nothing (reads with ``prefer_native=False`` count in
    neither)."""
    with _counts_lock:
        return dict(_counts)


def reset_read_counts() -> None:
    with _counts_lock:
        for key in _counts:
            _counts[key] = 0


def _count(key: str) -> None:
    with _counts_lock:
        _counts[key] += 1


def read_nifti(path: Union[str, Path],
               prefer_native: bool = True) -> NiftiImage:
    """Read a .nii / .nii.gz file.

    Uses the native C++ reader (``native/deepatlas_io.cpp``: voxels as
    float32, the affine from the sform or else from pixdim) when the
    library is available and decodes the file, falling back to this Python
    parser (voxels in the file's type).
    """
    if prefer_native:
        from ._native import read_nifti_native
        res = read_nifti_native(str(path))
        if res is not None:
            _count("native")
            data, spacing, affine = res
            return NiftiImage(data=data, spacing=spacing,
                              affine=np.asarray(affine, np.float64))
        _count("fallback")
    with _open_maybe_gzip(path, "rb") as f:
        raw = f.read()

    if len(raw) < 348:
        raise ValueError(f"{path}: too short to be a NIfTI-1 file")
    if struct.unpack_from("<i", raw, 0)[0] == 348:
        bo = "<"
    elif struct.unpack_from(">i", raw, 0)[0] == 348:
        bo = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr)")

    dim = struct.unpack_from(bo + "8h", raw, 40)
    datatype = struct.unpack_from(bo + "h", raw, 70)[0]
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    vox_offset = int(struct.unpack_from(bo + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(bo + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(bo + "f", raw, 116)[0]
    sform_code = struct.unpack_from(bo + "h", raw, 254)[0]
    srow = np.array(struct.unpack_from(bo + "12f", raw, 280),
                    dtype=np.float64).reshape(3, 4)
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    ndim = dim[0]
    shape_xyz = [max(1, dim[i + 1]) for i in range(min(ndim, 3))]
    n_extra = 1
    for i in range(3, ndim):
        n_extra *= max(1, dim[i + 1])
    nx, ny, nz = (shape_xyz + [1, 1, 1])[:3]

    count = nx * ny * nz * n_extra
    arr = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    # disk order: x fastest -> C-order shape (extra..., z, y, x)
    if n_extra > 1:
        arr = arr.reshape(n_extra, nz, ny, nx)
    else:
        arr = arr.reshape(nz, ny, nx)
    arr = np.asarray(arr, dtype=dtype.newbyteorder("="))

    if scl_slope not in (0.0, 1.0) or scl_inter not in (0.0,):
        if scl_slope == 0.0:
            scl_slope = 1.0
        arr = arr.astype(np.float32) * scl_slope + scl_inter

    spacing = (float(pixdim[1]) or 1.0, float(pixdim[2]) or 1.0,
               float(pixdim[3]) or 1.0)
    affine = None
    if sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = srow
    return NiftiImage(data=arr, spacing=spacing, affine=affine)


def write_nifti(path: Union[str, Path], image: Union[NiftiImage, np.ndarray],
                like: Optional[NiftiImage] = None) -> None:
    """Write a .nii / .nii.gz file (gzip chosen from the extension)."""
    if isinstance(image, np.ndarray):
        image = NiftiImage(data=image)
    if like is not None:
        image = NiftiImage(data=image.data).copy_information(like)

    data = np.ascontiguousarray(image.data)
    if data.ndim == 3:
        nz, ny, nx = data.shape
        dim = (3, nx, ny, nz, 1, 1, 1, 1)
    elif data.ndim == 4:
        nt, nz, ny, nx = data.shape
        dim = (4, nx, ny, nz, nt, 1, 1, 1)
    else:
        raise ValueError(f"can only write 3D/4D volumes, got {data.shape}")

    dt = np.dtype(data.dtype)
    if dt not in _DTYPE_CODES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    datatype = _DTYPE_CODES[dt]
    bitpix = dt.itemsize * 8
    sx, sy, sz = image.spacing

    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, datatype)
    struct.pack_into("<h", header, 72, bitpix)
    struct.pack_into("<8f", header, 76, 1.0, sx, sy, sz, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", header, 108, 352.0)   # vox_offset
    struct.pack_into("<f", header, 112, 1.0)     # scl_slope
    struct.pack_into("<f", header, 116, 0.0)     # scl_inter
    struct.pack_into("<h", header, 254, 1)       # sform_code
    if image.affine is not None:
        srow = np.asarray(image.affine[:3, :], dtype=np.float32)
    else:
        srow = np.diag([sx, sy, sz, 1.0]).astype(np.float32)[:3, :]
    struct.pack_into("<12f", header, 280, *srow.reshape(-1))
    header[344:348] = b"n+1\x00"

    payload = bytes(header) + data.tobytes()
    path = Path(path)
    if path.suffix == ".gz":
        with gzip.open(path, "wb", compresslevel=4) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
