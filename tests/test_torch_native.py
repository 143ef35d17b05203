"""deepatlas_torch's binding of the native I/O library against the JAX
package's binding of the same library and its Python reader.

Both bindings load ``native/deepatlas_io.cpp`` (built by each package into
its own directory); the same inputs through both must give the same bits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from deepatlas_tpu.data import _native as jax_native
from deepatlas_tpu.data.nifti import NiftiImage as JaxNiftiImage
from deepatlas_tpu.data.nifti import read_nifti as jax_read_nifti
from deepatlas_tpu.data.nifti import write_nifti as jax_write_nifti
from deepatlas_torch.data import (NiftiImage, read_counts, read_nifti,
                                  reset_read_counts, write_nifti)
from deepatlas_torch.data import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both libraries build here (g++ and zlib are on the test host)."""
    assert _native.available(), _native.build_error
    assert jax_native.available()


@pytest.fixture
def vol(rng):
    return (rng.rand(13, 17, 19) * 100).astype(np.float32)


def test_read_matches_jax_native_and_python_readers(tmp_path, vol):
    path = str(tmp_path / "v.nii.gz")
    write_nifti(path, NiftiImage(data=vol, spacing=(1.5, 2.0, 2.5)))
    data, spacing, affine = _native.read_nifti_native(path)
    jdata, jspacing, jaffine = jax_native.read_nifti_native(path)
    py = jax_read_nifti(path, prefer_native=False)
    assert data.dtype == np.float32 and data.shape == vol.shape
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(data, np.asarray(py.data, np.float32))
    assert spacing == jspacing
    np.testing.assert_allclose(spacing, py.spacing, rtol=1e-6)
    np.testing.assert_array_equal(affine, jaffine)
    # the header from the file's first bytes is what da_nifti_header reads
    dims = np.zeros(8, np.int32)
    pixdim = np.zeros(8, np.float32)
    dtype_code = np.zeros(1, np.int32)
    assert _native._load().da_nifti_header(
        path.encode(), _native._ptr(dims, _native._i32p),
        _native._ptr(pixdim), _native._ptr(dtype_code, _native._i32p)) == 0
    assert tuple(dims) == _native._header_dims(path)
    assert dtype_code[0] == 16 and tuple(pixdim[1:4]) == (1.5, 2.0, 2.5)


def test_native_write_read_by_jax(tmp_path, vol):
    path = str(tmp_path / "w.nii.gz")
    assert _native.write_nifti_native(path, vol, spacing=(2.0, 1.0, 3.0))
    back = jax_read_nifti(path, prefer_native=False)
    np.testing.assert_array_equal(np.asarray(back.data), vol)
    np.testing.assert_allclose(back.spacing, (2.0, 1.0, 3.0), rtol=1e-6)
    seg = np.arange(13 * 17 * 19).reshape(vol.shape) % 7
    path8 = str(tmp_path / "w8.nii.gz")
    assert _native.write_nifti_native(path8, seg, as_uint8=True)
    back = jax_read_nifti(path8, prefer_native=False)
    assert back.data.dtype == np.uint8
    np.testing.assert_array_equal(back.data, seg)


def test_read_nifti_prefers_native_and_falls_back(tmp_path, vol):
    path = str(tmp_path / "p.nii.gz")
    jax_write_nifti(path, JaxNiftiImage(data=vol))
    reset_read_counts()
    img = read_nifti(path)
    assert read_counts() == {"native": 1, "fallback": 0}
    ref = jax_read_nifti(path)
    np.testing.assert_array_equal(img.data, ref.data)
    np.testing.assert_array_equal(img.affine, ref.affine)
    assert img.spacing == ref.spacing
    py = read_nifti(path, prefer_native=False)
    np.testing.assert_array_equal(img.data, py.data)
    assert read_counts() == {"native": 1, "fallback": 0}
    # int64 voxels: a type the library does not decode -> the Python parser
    big = np.arange(60, dtype=np.int64).reshape(3, 4, 5)
    path64 = str(tmp_path / "i64.nii")
    write_nifti(path64, big)
    assert _native.read_nifti_native(path64) is None
    back = read_nifti(path64)
    assert back.data.dtype == np.int64
    np.testing.assert_array_equal(back.data, big)
    assert read_counts() == {"native": 1, "fallback": 1}
    # not a NIfTI file at all: native None, the parser raises as before
    junk = tmp_path / "junk.nii"
    junk.write_bytes(b"\x00" * 400)
    assert _native.read_nifti_native(str(junk)) is None
    with pytest.raises(ValueError, match="NIfTI"):
        read_nifti(junk)


def test_uint8_labels(tmp_path, rng):
    seg = rng.randint(0, 32, (9, 11, 13)).astype(np.uint8)
    path = str(tmp_path / "s.nii.gz")
    write_nifti(path, NiftiImage(data=seg))
    data = _native.read_nifti_native(path)[0]
    np.testing.assert_array_equal(data, jax_native.read_nifti_native(path)[0])
    np.testing.assert_array_equal(data.astype(np.uint8), seg)
    np.testing.assert_array_equal(read_nifti(path).data, seg)


@pytest.mark.parametrize("out_shape", [(7, 9, 29), (13, 17, 19), (20, 5, 3)])
def test_resample_normalize_bilateral_bit_for_bit(vol, out_shape):
    """The two bindings call the same C code: equal to the last bit."""
    for name in ("resample_trilinear_native", "resample_nearest_native"):
        got = getattr(_native, name)(vol, out_shape)
        ref = getattr(jax_native, name)(vol, out_shape)
        assert got.shape == out_shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    for clamp in (False, True):
        got = _native.normalize_native(vol.copy(), clamp01=clamp)
        ref = jax_native.normalize_native(vol.copy(), clamp01=clamp)
        np.testing.assert_array_equal(got, ref)
    unit = vol / 100.0
    for sigmas in ((0.5, 0.06, 50), (1.2, 0.2, 20)):
        got = _native.bilateral_native(unit, *sigmas)
        ref = jax_native.bilateral_native(unit, *sigmas)
        np.testing.assert_array_equal(got, ref)
    # normalize in place on a float32 contiguous array, as the JAX binding
    v = vol.copy()
    assert _native.normalize_native(v, clamp01=False) is v
    np.testing.assert_allclose(v, (vol - vol.mean()) / vol.std(), atol=1e-4)


def test_importing_the_data_package_builds_nothing(tmp_path):
    code = (
        "import deepatlas_torch.data as d\n"
        "from deepatlas_torch.data import _native as n\n"
        "import deepatlas_torch\n"
        "print(n._lib is None and not n._tried)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"
    # the library's name follows its source and flags, inside the port's
    # own ignored build directory
    assert _native.lib_path().parent == _native.BUILD_DIR
    assert _native.BUILD_DIR.parts[-2:] == ("kernels", "_build")
    assert _native.lib_path().is_file()
