"""deepatlas_torch's host transforms against deepatlas_tpu's on seeded
volumes: IdentityTransform, PadVolume, SegmentationLabelFilter and, through
the native tier and through the numpy fallbacks, Resample, Normalization
and BilateralFilter.  The same code on the same inputs: equal bits (the
fallbacks too)."""
import copy
from unittest import mock

import numpy as np
import pytest

from deepatlas_tpu.data import _native as jax_native
from deepatlas_tpu.data import transforms as jt
from deepatlas_torch.data import (BilateralFilter, IdentityTransform,
                                  Normalization, PadVolume, Resample,
                                  SegmentationLabelFilter)
from deepatlas_torch.data import _native

NATIVE_FNS = ("resample_trilinear_native", "resample_nearest_native",
              "normalize_native", "bilateral_native")


@pytest.fixture
def sample(rng):
    img = rng.rand(9, 12, 10, 1).astype(np.float32)
    seg = rng.randint(0, 6, (9, 12, 10)).astype(np.uint8)
    return {"image": img, "segmentation": seg, "name": "s0",
            "spacing": (1.2, 0.9, 1.5)}


@pytest.fixture(params=["native", "numpy"])
def tier(request):
    """Both packages on the native library, or both on their numpy
    fallbacks (every native entry point returning None)."""
    if request.param == "native":
        assert _native.available() and jax_native.available()
        yield request.param
        return
    with mock.patch.multiple(_native, **{f: lambda *a, **k: None
                                         for f in NATIVE_FNS}), \
            mock.patch.multiple(jax_native, **{f: lambda *a, **k: None
                                               for f in NATIVE_FNS}):
        yield request.param


def run_both(ours, theirs, sample):
    a = ours(copy.deepcopy(sample))
    b = theirs(copy.deepcopy(sample))
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key
    return a


def test_identity_pad_and_label_filter(sample):
    assert run_both(IdentityTransform(), jt.IdentityTransform(),
                    sample)["image"].shape == (9, 12, 10, 1)
    for mode in ("constant", "edge", "reflect"):
        out = run_both(PadVolume((12, 13, 15), mode),
                       jt.PadVolume((12, 13, 15), mode), sample)
        assert out["image"].shape == (12, 13, 15, 1)
        assert out["segmentation"].shape == (12, 13, 15)
    with pytest.raises(ValueError, match="smaller"):
        PadVolume((8, 13, 15))(copy.deepcopy(sample))
    out = run_both(SegmentationLabelFilter([2, 5]),
                   jt.SegmentationLabelFilter([2, 5]), sample)
    assert not np.isin(out["segmentation"], [2, 5]).any()
    no_seg = {"image": sample["image"], "segmentation": None}
    assert SegmentationLabelFilter([1])(no_seg)["segmentation"] is None


@pytest.mark.parametrize("voxel_size", [1.0, (0.7, 1.3, 2.0)])
@pytest.mark.parametrize("seg_interpolator", ["nearest", "linear"])
def test_resample(tier, sample, voxel_size, seg_interpolator):
    out = run_both(Resample(voxel_size, seg_interpolator),
                   jt.Resample(voxel_size, seg_interpolator), sample)
    vs = (voxel_size,) * 3 if isinstance(voxel_size, float) else voxel_size
    want = tuple(int(np.ceil(sample["spacing"][a] * n / vs[a]))
                 for a, n in ((2, 9), (1, 12), (0, 10)))
    assert out["image"].shape == want + (1,)
    assert out["segmentation"].dtype == np.uint8
    assert out["spacing"] == tuple(float(v) for v in vs)
    with pytest.raises(ValueError):
        Resample(1.0, "cubic")


def test_normalization(tier, sample):
    out = run_both(Normalization(), jt.Normalization(), sample)
    np.testing.assert_allclose(out["image"].mean(), 0.0, atol=1e-5)
    np.testing.assert_allclose(out["image"].std(), 1.0, atol=1e-4)


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_bilateral_filter(tier, sample, ratio):
    """Seeded draws: both filters take the same ``rand(1)`` per call, so
    over several calls they filter the same samples."""
    ours = BilateralFilter(0.7, 0.1, 30, ratio, np.random.RandomState(5))
    theirs = jt.BilateralFilter(0.7, 0.1, 30, ratio,
                                np.random.RandomState(5))
    filtered = 0
    for _ in range(4):
        out = run_both(ours, theirs, sample)
        filtered += not np.array_equal(out["image"], sample["image"])
    assert filtered == 4 if ratio == 1.0 else 0 < filtered < 4
