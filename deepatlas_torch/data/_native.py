"""ctypes binding of the native I/O library, ``native/deepatlas_io.cpp``.

The same C library the JAX package binds (``deepatlas_tpu/data/_native.py``)
with the same seven entry points and the same Python functions and return
conventions: NIfTI-1 read (zlib inflate, dtype conversion, scl_slope /
scl_inter) and write, trilinear and nearest resampling, zero-mean / unit
variance normalisation and the bilateral filter.  Every function returns
``None`` (``False`` for the writer) where the library is not available or a
file is one it cannot decode; the callers then take their numpy fallbacks.
ctypes releases the interpreter lock for the call, so the loader's decode
threads inflate concurrently.

The library is built at first use, never at import: ``g++ -O3 -fPIC
-std=c++17 -shared ... -lz`` (``native/Makefile``'s flags) into this
package's ignored build directory ``deepatlas_torch/kernels/_build/``, under
a name that carries a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one reused.  A failed build keeps the compiler's
output in ``build_error``.

One departure from the JAX binding, for speed only: ``read_nifti_native``
takes the header from the file's first 352 bytes (``gzip`` inflates only
those), where the JAX binding calls ``da_nifti_header``, which inflates the
whole file once more before ``da_nifti_read_f32`` inflates it for the
voxels.  The header is checked as ``da_nifti_header`` checks it.
"""
from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import struct
import subprocess
import threading
import time
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "deepatlas_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lz",)

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i32 = ctypes.c_int32
_SIGNATURES = {
    "da_nifti_header": ([ctypes.c_char_p, _i32p, _f32p, _i32p], ctypes.c_int),
    "da_nifti_read_f32": ([ctypes.c_char_p, _f32p, ctypes.c_int64, _f32p,
                           _f32p], ctypes.c_int),
    "da_nifti_write": ([ctypes.c_char_p, _f32p, _i32, _i32, _i32, _f32p,
                        ctypes.c_int], ctypes.c_int),
    "da_resample_nearest": ([_f32p, _i32, _i32, _i32, _f32p, _i32, _i32,
                             _i32], None),
    "da_resample_trilinear": ([_f32p, _i32, _i32, _i32, _f32p, _i32, _i32,
                               _i32], None),
    "da_normalize": ([_f32p, ctypes.c_int64, ctypes.c_int], None),
    "da_bilateral": ([_f32p, _f32p, _i32, _i32, _i32, ctypes.c_float,
                      ctypes.c_float, _i32], None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None
build_seconds: Optional[float] = None


def lib_path() -> Path:
    """Where the library lands: a hash of the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdeepatlas_io-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile the library into ``out`` (through a temporary name, so a
    concurrent process never loads a half-written file)."""
    global build_error, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), *LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        build_error = f"{' '.join(cmd)}: {e}"
        return
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        build_error = (f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                       f"{proc.stdout}{proc.stderr}")
        tmp.unlink(missing_ok=True)
        return
    os.replace(tmp, out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.is_file():
            build_error = f"{SOURCE} not found"
            return None
        out = lib_path()
        if not out.exists():
            _build(out)
            if not out.exists():
                return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            build_error = f"loading {out}: {e}"
            return None
        for name, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def _ptr(a: np.ndarray, kind=_f32p):
    return a.ctypes.data_as(kind)


def _header_dims(path: str) -> Optional[Tuple[int, ...]]:
    """``dim[0..7]`` from the file's first 352 bytes, or None where
    ``da_nifti_header`` would refuse the file (unreadable, not NIfTI-1, or
    not in this host's byte order)."""
    try:
        with open(path, "rb") as f:
            gz = f.read(2) == b"\x1f\x8b"
        opener = gzip.open if gz else open
        with opener(path, "rb") as f:
            raw = f.read(352)
    except (OSError, EOFError, zlib.error):
        return None
    if len(raw) < 348 or struct.unpack_from("=i", raw, 0)[0] != 348:
        return None
    return struct.unpack_from("=8h", raw, 40)


def read_nifti_native(path: str):
    """Native NIfTI read -> (data (z,y,x) float32, spacing, affine) or None
    when the library (or the file's encoding) is unsupported."""
    lib = _load()
    if lib is None:
        return None
    dims = _header_dims(str(path))
    if dims is None:
        return None
    ndim = int(dims[0])
    if ndim < 3 or ndim > 5:
        return None
    shape_xyz = [int(dims[i]) for i in range(1, ndim + 1)]
    n = int(np.prod(shape_xyz))
    out = np.empty(n, np.float32)
    spacing = np.zeros(3, np.float32)
    affine = np.zeros(16, np.float32)
    rc = lib.da_nifti_read_f32(str(path).encode(), _ptr(out), n,
                               _ptr(spacing), _ptr(affine))
    if rc != 0:
        return None
    # NIfTI stores x fastest -> C-view is (..., z, y, x); squeeze trailing
    data = out.reshape(tuple(reversed(shape_xyz)))
    while data.ndim > 3 and data.shape[0] == 1:
        data = data[0]
    return data, tuple(float(s) for s in spacing), affine.reshape(4, 4)


def write_nifti_native(path: str, data: np.ndarray,
                       spacing: Tuple[float, float, float] = (1., 1., 1.),
                       as_uint8: bool = False) -> bool:
    lib = _load()
    if lib is None:
        return False
    d = np.ascontiguousarray(data, np.float32)
    nz, ny, nx = d.shape
    sp = np.asarray(spacing, np.float32)
    rc = lib.da_nifti_write(str(path).encode(), _ptr(d), nx, ny, nz,
                            _ptr(sp), 1 if as_uint8 else 0)
    return rc == 0


def _resample(entry: str, vol: np.ndarray,
              out_shape: Tuple[int, int, int]) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(vol, np.float32)
    sz, sy, sx = src.shape
    dz, dy, dx = (int(s) for s in out_shape)
    dst = np.empty((dz, dy, dx), np.float32)
    getattr(lib, entry)(_ptr(src), sx, sy, sz, _ptr(dst), dx, dy, dz)
    return dst


def resample_trilinear_native(vol: np.ndarray,
                              out_shape: Tuple[int, int, int]
                              ) -> Optional[np.ndarray]:
    """Resample (z, y, x) float32 volume to out_shape (z, y, x)."""
    return _resample("da_resample_trilinear", vol, out_shape)


def resample_nearest_native(vol: np.ndarray,
                            out_shape: Tuple[int, int, int]
                            ) -> Optional[np.ndarray]:
    """Nearest-neighbour resample (label masks) to out_shape (z, y, x)."""
    return _resample("da_resample_nearest", vol, out_shape)


def normalize_native(vol: np.ndarray, clamp01: bool = True
                     ) -> Optional[np.ndarray]:
    """Zero-mean / unit-variance normalisation (then a clamp to [0, 1] with
    ``clamp01``); in place where ``vol`` is already float32 and contiguous,
    as in the JAX binding."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(vol, np.float32)
    lib.da_normalize(_ptr(v), v.size, 1 if clamp01 else 0)
    return v


def bilateral_native(vol: np.ndarray, domain_sigma: float,
                     range_sigma: float,
                     n_range_samples: int = 50) -> Optional[np.ndarray]:
    """3-D bilateral filter (z, y, x) float32."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(vol, np.float32)
    sz, sy, sx = src.shape
    dst = np.empty_like(src)
    lib.da_bilateral(_ptr(src), _ptr(dst), sx, sy, sz, float(domain_sigma),
                     float(range_sigma), int(n_range_samples))
    return dst
