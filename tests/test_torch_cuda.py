"""deepatlas_torch CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Shapes are chosen to reach every edge of the kernels: a 1-channel input,
widths that are not multiples of the 32-wide tile, Cout that is not a
multiple of 8 (scalar stores) and Cout above one 32-channel block; for the
warp kernels, samples past every border, several channels, batch 2 and a
grid of another shape than the volume.
Tolerances as in chip_smoke.py: float32 differs only in summation order
(1e-4 of the output's range); bfloat16 inputs are the same on both sides
and both accumulate in float32, so the outputs differ by at most one final
rounding (1e-2 of the range).
"""
import numpy as np
import pytest
import torch

from chip_smoke import plain_math
from deepatlas_torch.kernels import (KERNELS, conv3d_k3_wgrad,
                                     conv3d_k3_wgrad_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,wlead", [("conv3d_k3", (3, 3, 3)),
                                        ("conv3d_point", ()),
                                        ("deconv2x", (2, 2, 2))])
@pytest.mark.parametrize("shape,cin,cout", [((2, 5, 7, 20), 1, 8),
                                            ((1, 6, 9, 33), 48, 16),
                                            ((2, 4, 4, 4), 16, 5),
                                            ((1, 3, 8, 40), 96, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, name, wlead, shape, cin, cout,
                                      dtype):
    rng = np.random.RandomState(230)
    fn, plain = KERNELS[name]
    x = torch.from_numpy(rng.rand(*shape, cin).astype(np.float32)).to(
        cuda, dtype)
    w = torch.from_numpy((rng.randn(*wlead, cin, cout) * 0.2).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(
        cuda)
    before = fn.launches
    got = fn(x, w, bias)
    ref = plain(x, w, bias)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
def test_wrappers_raise_on_mixed_devices(cuda):
    x = torch.zeros(1, 2, 4, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        KERNELS["conv3d_k3"][0](x, torch.zeros(3, 3, 3, 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [((2, 5, 7, 20), 1, 8),
                                            ((1, 6, 9, 33), 48, 16),
                                            ((1, 21, 25, 21), 64, 64),
                                            ((1, 3, 8, 40), 96, 72),
                                            ((2, 4, 4, 4), 8, 16),
                                            ((1, 7, 3, 65), 16, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_matches_plain_on_card(cuda, shape, cin, cout, dtype):
    """Kernel D at odd sizes (ragged tiles in every axis, the conv's zero
    padding at every border), batch 2, every (CI, CO) variant of the
    kernel, and Cin/Cout that fill their last channel block only partly.
    Both sides sum the same float32 products (bf16 products are exact in
    float32), so 1e-4 of the largest entry holds in both types; and the
    kernel's fixed summation order makes two runs equal bit for bit."""
    rng = np.random.RandomState(230)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, dtype)
    g = torch.from_numpy(rng.randn(*shape, cout).astype(np.float32)).to(
        cuda, dtype)
    before = conv3d_k3_wgrad.launches
    got = conv3d_k3_wgrad(x, g)
    again = conv3d_k3_wgrad(x, g)
    ref = conv3d_k3_wgrad_plain(x, g)
    torch.cuda.synchronize()
    assert conv3d_k3_wgrad.launches == before + 2
    assert got.shape == (3, 3, 3, cin, cout) and got.dtype == torch.float32
    assert torch.equal(got, again)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name,wlead,up", [("conv3d_k3", (3, 3, 3), 1),
                                           ("conv3d_point", (), 1),
                                           ("deconv2x", (2, 2, 2), 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_on_card_matches_plain_math(cuda, name, wlead, up, dtype):
    """One backward of each autograd Function on the card: dx through
    kernels A / B (or the deconv's matrix product), dW through kernel D (or
    the matrix products), db, against the same Function on the plain math;
    the upstream gradient is a non-contiguous channel slice."""
    rng = np.random.RandomState(230)
    shape, cin, cout = (1, 5, 6, 35), 48, 16
    fn = KERNELS[name][0]
    x0 = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, dtype)
    w0 = torch.from_numpy((rng.randn(*wlead, cin, cout) * 0.1).astype(
        np.float32)).to(cuda)
    b0 = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    out_shape = (shape[0],) + tuple(up * s for s in shape[1:])
    ct = torch.from_numpy(rng.randn(*out_shape, cout + 2).astype(
        np.float32)).to(cuda, dtype)[..., 1:-1]

    def grads():
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        fn(x, w, b).backward(ct)
        torch.cuda.synchronize()
        return x.grad, w.grad, b.grad

    counts = {k: f.launches for k, (f, _) in KERNELS.items()}
    got = grads()
    launched = {k: f.launches - counts[k] for k, (f, _) in KERNELS.items()}
    want = {"conv3d_k3": {"conv3d_k3": 2, "conv3d_k3_wgrad": 1},
            "conv3d_point": {"conv3d_point": 2}, "deconv2x": {"deconv2x": 1}}
    assert {k: v for k, v in launched.items() if v} == want[name]
    with plain_math():
        ref = grads()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item()


def _warp_inputs(cuda, shape, c, dtype, amplitude, out_shape=None):
    """A volume, an upstream gradient and a grid of random displacements of
    up to ``amplitude`` voxels (some samples leave the volume)."""
    from deepatlas_torch.ops import identity_grid_batch, normalize_displacement

    rng = np.random.RandomState(230)
    vol = torch.from_numpy(rng.rand(*shape, c).astype(np.float32)).to(
        cuda, dtype)
    if out_shape is None:
        disp = torch.from_numpy(
            (rng.rand(*shape, 3) * 2 - 1).astype(np.float32)) * amplitude
        grid = (normalize_displacement(disp)
                + identity_grid_batch(shape)).to(cuda).contiguous()
    else:
        grid = torch.from_numpy((rng.rand(shape[0], *out_shape, 3) * 2.4
                                 - 1.2).astype(np.float32)).to(cuda)
    ct = torch.from_numpy(rng.randn(*grid.shape[:4], c).astype(
        np.float32)).to(cuda, dtype)
    return vol, grid, ct


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,amplitude,out_shape", [
    ((1, 13, 17, 11), 1, 2.5, None), ((2, 9, 8, 35), 3, 6.0, None),
    ((1, 4, 5, 300), 2, 1.0, None), ((2, 7, 6, 5), 2, 0.0, (3, 4, 9)),
    ((1, 9, 10, 21), 8, 3.0, None), ((2, 7, 9, 13), 32, 4.0, None),
    ((1, 6, 5, 19), 33, 2.0, (5, 6, 7))],
    ids=["one_channel", "batch_channels", "wide", "other_output_shape",
         "eight_channels", "anatomy_channels", "ragged_channels"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_kernels_match_plain_on_card(cuda, shape, c, amplitude,
                                          out_shape, dtype):
    """Kernels E, F and G at odd sizes, batch 2, several channels, samples
    past every border and a grid of another shape than the volume; at C =
    8 and 32 E spreads a point's channels over lanes in 16-byte chunks, at
    33 it takes one thread a point; G spreads them over lanes at 8, 32 and
    33 (33: a second group of one channel).  Both sides compute the same float32 weights; the warp's
    output is rounded once to the values' type (1e-2 in bf16, 1e-5 in
    float32), the grid gradient (1e-4) and the splat (1e-5: the kernel's
    fixed-point sum is exact to 2^-e a term, the plain version's float sum
    to a few float32 roundings) are float32 in both types."""
    from deepatlas_torch import kernels

    vol, grid, ct = _warp_inputs(cuda, shape, c, dtype, amplitude, out_shape)
    before = kernels.launch_counts()
    got = (kernels.warp_trilinear(vol, grid),
           kernels.warp_grid_grad(vol, grid, ct),
           kernels.splat_trilinear(ct, grid, shape[1:]))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("warp_trilinear", "warp_grid_grad", "splat_trilinear"):
        assert after[name] == before[name] + 1
    ref = (kernels.warp_trilinear_plain(vol, grid),
           kernels.warp_grid_grad_plain(vol, grid, ct),
           kernels.splat_trilinear_plain(ct, grid, shape[1:]))
    assert kernels.launch_counts() == after         # plain launches nothing
    tols = (1e-5 if dtype == torch.float32 else 1e-2, 1e-4, 1e-5)
    for a, b, tol in zip(got, ref, tols):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item()
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype \
        == torch.float32


def _splat_close(got, ref):
    assert got.shape == ref.shape and got.dtype == torch.float32
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("field,amplitude", [("smooth", 2.5),
                                             ("saturated", 20.0)])
@pytest.mark.parametrize("c", [1, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_rerun_is_bit_identical_on_card(cuda, field, amplitude, c,
                                              dtype):
    """G adds in 64-bit fixed point, so three calls give the same bits,
    on a smooth field and on one clamped to 3 voxels nearly everywhere
    (many points on one voxel), at the splat of ones' one channel and the
    anatomy's 32."""
    from deepatlas_torch import kernels
    from deepatlas_torch.ops import clamp_displacement

    shape = (1, 24, 28, 40)
    _, grid, ct = _warp_inputs(cuda, shape, c, dtype, amplitude)
    grid = clamp_displacement(grid, 3).contiguous()
    outs = [kernels.splat_trilinear(ct, grid, shape[1:]) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _splat_close(outs[0], kernels.splat_trilinear_plain(ct, grid, shape[1:]))


@pytest.mark.cuda
def test_fhard_onehot_splat_matches_plain_on_card(cuda):
    """The f-hard branch's splat: a float32 one-hot of 32 classes (most
    cotangents exactly 0, which the kernel skips), against the plain
    version; summed over the channels it is the splat of ones."""
    from deepatlas_torch import kernels

    shape = (1, 20, 24, 28)
    _, grid, _ = _warp_inputs(cuda, shape, 1, torch.float32, 4.0)
    rng = np.random.RandomState(231)
    labels = torch.from_numpy(rng.randint(0, 32, shape)).to(cuda)
    onehot = torch.nn.functional.one_hot(labels, 32).float().contiguous()
    got = kernels.splat_trilinear(onehot, grid, shape[1:])
    _splat_close(got, kernels.splat_trilinear_plain(onehot, grid, shape[1:]))
    ones = kernels.splat_trilinear(torch.ones(*shape, 1, device=cuda), grid,
                                   shape[1:])
    torch.cuda.synchronize()
    assert (got.sum(-1) - ones[..., 0]).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_warp_32_channels_at_a_ragged_shape_on_card(cuda, dtype, aligned):
    """E at the anatomy's 32 channels on 7 x 9 x 13 points (no multiple of
    a block's points), with the volume 16-byte aligned (vector loads) or
    one element off (one thread a point), against the plain version."""
    from deepatlas_torch import kernels

    shape = (1, 7, 9, 13)
    vol, grid, _ = _warp_inputs(cuda, shape, 32, dtype, 3.0)
    if not aligned:
        flat = torch.empty(vol.numel() + 1, dtype=dtype, device=cuda)
        flat[1:] = vol.reshape(-1)
        vol = flat[1:].view(vol.shape)
        assert vol.data_ptr() % 16 != 0 and vol.is_contiguous()
    got = kernels.warp_trilinear(vol, grid)
    ref = kernels.warp_trilinear_plain(vol, grid)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() \
        <= tol * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 32])
def test_splat_nonfinite_channel_is_nan_on_card(cuda, c):
    """A channel whose cotangent holds a NaN or an infinity is NaN in the
    whole output; the other channels are as without it."""
    from deepatlas_torch import kernels

    shape = (1, 6, 7, 9)
    _, grid, ct = _warp_inputs(cuda, shape, c, torch.float32, 2.0)
    bad = ct.clone()
    bad[0, 2, 3, 4, 0] = float("nan")
    if c > 1:
        bad[0, 1, 1, 1, 5] = float("inf")
    got = kernels.splat_trilinear(bad, grid, shape[1:])
    clean = kernels.splat_trilinear(ct, grid, shape[1:])
    torch.cuda.synchronize()
    nan = [0] if c == 1 else [0, 5]
    assert torch.isnan(got[..., nan]).all()
    keep = [i for i in range(c) if i not in nan]
    assert torch.equal(got[..., keep], clean[..., keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_sample_backward_on_card(cuda, dtype):
    """The differentiable entry point with the clamp: dvol through G and
    dgrid through F against the same Function on the plain math; F and G
    launch only for an input that requires a gradient."""
    from deepatlas_torch import kernels

    vol0, grid0, ct = _warp_inputs(cuda, (1, 12, 10, 37), 2, dtype, 6.0)

    def grads(vol_grad=True, mode="full"):
        v = vol0.clone().requires_grad_(vol_grad)
        g = grid0.clone().requires_grad_(True)
        kernels.grid_sample(v, g, max_disp=3, grad=mode).backward(ct)
        torch.cuda.synchronize()
        return v.grad, g.grad

    def launched(fn, *args, **kwargs):
        before = kernels.launch_counts()
        out = fn(*args, **kwargs)
        after = kernels.launch_counts()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    got, counts = launched(grads)
    assert counts == {"warp_trilinear": 1, "warp_grid_grad": 1,
                      "splat_trilinear": 1}
    _, counts = launched(grads, vol_grad=False)
    assert counts == {"warp_trilinear": 1, "warp_grid_grad": 1}
    (_, no_grid), counts = launched(grads, mode="values")
    assert counts == {"warp_trilinear": 1, "splat_trilinear": 1}
    assert no_grid is None
    with plain_math():
        ref = grads()
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, b, tol in zip(got, ref, (1e-5 if dtype == torch.float32
                                    else 1e-2, 1e-4)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item()
    # past the clamp's bound the field gets no gradient
    assert (got[1] == 0).any() and (got[1] != 0).any()


@pytest.mark.cuda
def test_warp_wrappers_raise_on_mixed_devices(cuda):
    from deepatlas_torch import kernels

    vol = torch.zeros(1, 4, 4, 4, 1, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        kernels.warp_trilinear(vol, torch.zeros(1, 4, 4, 4, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [((2, 5, 7, 20), 2, 16),
                                            ((1, 6, 9, 67), 16, 32),
                                            ((1, 21, 25, 21), 32, 32),
                                            ((1, 3, 8, 41), 24, 3),
                                            ((1, 4, 4, 4), 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_conv_on_card(cuda, shape, cin, cout, dtype):
    """Stride 2 of kernels A and D at odd and even sizes (``ceil(n / 2)``
    outputs, ragged tiles, the padding at every border) and every channel
    variant, then one backward of the strided Function: forward and ``dW``
    on the strided kernels, ``dx`` on the stride-1 kernel over the
    zero-stuffed gradient.  Tolerances as for stride 1."""
    from deepatlas_torch.kernels import conv3d_k3, conv3d_k3_plain

    rng = np.random.RandomState(230)
    x0 = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, dtype)
    w0 = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) * 0.1).astype(
        np.float32)).to(cuda)
    b0 = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(cuda)
    out_shape = (shape[0],) + tuple(-(-n // 2) for n in shape[1:])
    ct = torch.from_numpy(rng.randn(*out_shape, cout).astype(
        np.float32)).to(cuda, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2

    def close(a, b, tol):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item()

    got = conv3d_k3(x0, w0, b0, stride=2)
    assert got.shape == out_shape + (cout,)
    close(got, conv3d_k3_plain(x0, w0, b0, stride=2), tol)
    dw = conv3d_k3_wgrad(x0, ct, stride=2)
    assert torch.equal(dw, conv3d_k3_wgrad(x0, ct, stride=2))
    close(dw, conv3d_k3_wgrad_plain(x0, ct, stride=2), 1e-4)

    def grads():
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        conv3d_k3(x, w, b, stride=2).backward(ct)
        torch.cuda.synchronize()
        return x.grad, w.grad, b.grad

    counts = {k: f.launches for k, (f, _) in KERNELS.items()}
    got = grads()
    launched = {k: f.launches - counts[k] for k, (f, _) in KERNELS.items()}
    assert {k: v for k, v in launched.items() if v} == {
        "conv3d_k3": 2, "conv3d_k3_wgrad": 1}
    with plain_math():
        ref = grads()
    for a, b in zip(got, ref):
        close(a, b, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c", [((1, 5, 7, 20), 8), ((2, 3, 4, 33), 5),
                                     ((1, 4, 6, 9), 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nearest_up2x_on_card(cuda, shape, c, dtype):
    """The VoxelMorph decoder's 2x upsample on the transposed-conv kernel
    with the identity bank: one launch, equal to ``nearest_resize`` bit for
    bit (every tap is a copy); its input gradient, a sum of 8 values through
    the backward's matrix product, within 1e-5 (float32) or one rounding
    (bfloat16) of the float32 sum."""
    from deepatlas_torch.kernels import deconv2x, nearest_up2x
    from deepatlas_torch.ops import nearest_resize

    rng = np.random.RandomState(230)
    x = torch.from_numpy(rng.randn(*shape, c).astype(np.float32)).to(
        cuda, dtype).requires_grad_(True)
    out_shape = tuple(2 * n for n in shape[1:])
    ct = torch.from_numpy(rng.randn(shape[0], *out_shape, c).astype(
        np.float32)).to(cuda, dtype)
    before = deconv2x.launches
    got = nearest_up2x(x)
    got.backward(ct)
    torch.cuda.synchronize()
    assert deconv2x.launches == before + 1
    assert torch.equal(got.detach(), nearest_resize(x.detach(), out_shape))
    b, d, h, w = shape
    ref = ct.float().view(b, d, 2, h, 2, w, 2, c).sum(dim=(2, 4, 6))
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert x.grad.dtype == dtype
    err = (x.grad.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()


def _anatomy_inputs(cuda, shape, n_class, amplitude, out_shape=None):
    """Moving and fixed int32 labels, a grid of random displacements of up
    to ``amplitude`` voxels (some samples leave the volume) or, with
    ``out_shape``, of random points in and past the volume, and a
    cotangent at the grid's points."""
    from deepatlas_torch.ops import identity_grid_batch, normalize_displacement

    rng = np.random.RandomState(230)
    lab_m = torch.from_numpy(rng.randint(0, n_class, shape).astype(
        np.int32)).to(cuda)
    if out_shape is None:
        disp = torch.from_numpy(
            (rng.rand(*shape, 3) * 2 - 1).astype(np.float32)) * amplitude
        grid = (normalize_displacement(disp)
                + identity_grid_batch(shape)).to(cuda).contiguous()
    else:
        grid = torch.from_numpy((rng.rand(shape[0], *out_shape, 3) * 2.4
                                 - 1.2).astype(np.float32)).to(cuda)
    lab_f = torch.from_numpy(rng.randint(0, n_class, grid.shape[:4]).astype(
        np.int32)).to(cuda)
    ct = torch.from_numpy(rng.randn(*grid.shape[:4]).astype(
        np.float32)).to(cuda)
    return lab_m, lab_f, grid, ct


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n_class,amplitude,out_shape", [
    ((1, 13, 17, 11), 32, 2.5, None), ((2, 9, 8, 35), 3, 6.0, None),
    ((1, 4, 5, 300), 5, 1.0, None), ((2, 7, 6, 5), 4, 0.0, (3, 4, 9))],
    ids=["smooth", "batch_border", "wide", "other_output_shape"])
def test_matched_kernels_match_plain_on_card(cuda, shape, n_class, amplitude,
                                             out_shape):
    """Kernels H, I and J at odd sizes, batch 2, samples past every border
    and a grid of another shape than the volume, against their plain
    versions: ``m`` to 1e-6 absolute (it lies in [0, 1]; both sides add the
    same 8 products), the derivative planes and J's cotangent to 1e-5 of
    their largest entry (another order of additions).  One writer per
    output: a rerun is bit-identical, and J is ``ct`` times I's planes bit
    for bit."""
    from deepatlas_torch import kernels

    lab_m, lab_f, grid, ct = _anatomy_inputs(cuda, shape, n_class, amplitude,
                                             out_shape)
    args = (lab_m, lab_f, grid)
    before = kernels.launch_counts()
    m = kernels.matched_warp(*args)
    m_fused, planes = kernels.matched_warp_fused(*args)
    dgrid = kernels.matched_grid_grad(*args, ct)
    again = (kernels.matched_warp(*args), *kernels.matched_warp_fused(*args),
             kernels.matched_grid_grad(*args, ct))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("matched_warp", "matched_warp_fused", "matched_grid_grad"):
        assert after[name] == before[name] + 2
    ref_m, ref_planes = kernels.matched_warp_fused_plain(*args)
    ref_dgrid = kernels.matched_grid_grad_plain(*args, ct)
    assert kernels.launch_counts() == after         # plain launches nothing
    assert m.shape == grid.shape[:4] and planes.shape == grid.shape
    assert m.dtype == planes.dtype == dgrid.dtype == torch.float32
    for a, b in zip((m, m_fused, planes, dgrid), again):
        assert torch.equal(a, b)
    assert torch.equal(m, m_fused)
    assert torch.equal(dgrid, ct[..., None] * planes)
    assert (m - ref_m).abs().max().item() <= 1e-6
    for a, b in ((planes, ref_planes), (dgrid, ref_dgrid)):
        err = (a - b).abs().max().item()
        assert err <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fused_grad", [False, True],
                         ids=["matched_grid_grad", "fused"])
def test_hard_anatomy_dice_on_card(cuda, fused_grad):
    """The anatomy dice and its deformation gradient on the card against
    the same Functions on the plain math: value to 1e-5 (per-class sums of
    float32 atomics in any order), gradient to 1e-4 of its largest entry;
    the launches that ``fused_grad`` selects; no gradient past the clamp."""
    from deepatlas_torch import kernels

    lab_m, lab_f, grid0, _ = _anatomy_inputs(cuda, (2, 12, 10, 37), 6, 6.0)

    def run():
        g = grid0.clone().requires_grad_(True)
        loss = kernels.hard_anatomy_dice(lab_m, lab_f, g, 6, max_disp=3,
                                         fused_grad=fused_grad)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), g.grad

    before = kernels.launch_counts()
    got = run()
    after = kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    matched = {"matched_warp_fused": 1} if fused_grad else {
        "matched_warp": 1, "matched_grid_grad": 1}
    assert launched == dict(matched, splat_trilinear=1, warp_grid_grad=1)
    with plain_math():
        ref = run()
    assert abs(got[0] - ref[0]) <= 1e-5
    assert (got[1] - ref[1]).abs().max().item() \
        <= 1e-4 * ref[1].abs().max().item()
    assert (got[1] == 0).any() and (got[1] != 0).any()


@pytest.mark.cuda
def test_matched_wrappers_raise_on_mixed_devices(cuda):
    from deepatlas_torch import kernels

    lab = torch.zeros(1, 4, 4, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="operands on"):
        kernels.matched_warp(lab, lab, torch.zeros(1, 4, 4, 4, 3))


# (moving labelled, fixed labelled) -> the anatomy kernels a joint seg step
# launches in that regime with hard_fused (C = 32 in the joint recipe; the
# warps here carry 4 one-hot or probability channels)
SEG_REGIME_LAUNCHES = {
    (False, False): {"warp_trilinear": 1, "splat_trilinear": 1},
    (False, True): {"splat_trilinear": 1},
    (True, False): {"warp_trilinear": 1},
    (True, True): {"matched_warp": 1, "splat_trilinear": 1}}


@pytest.mark.cuda
@pytest.mark.parametrize("flags", sorted(SEG_REGIME_LAUNCHES),
                         ids=["soft", "f_hard", "m_hard", "hard"])
def test_joint_seg_step_launches_per_regime_on_card(cuda, flags):
    """One joint seg step per label regime on small nets: the anatomy
    launches the regime's branch implies (the frozen reg net's forward is
    convolutions only), the same loss and gradients as the soft branch on
    the card (1e-4 of a tensor's largest entry: float32 nets, atomics in any
    order), and the frozen reg net untouched."""
    import functools

    from deepatlas_torch import kernels
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.models import UNetTemplate, VoxelMorphCVPR2018
    from deepatlas_torch.train import (TrainState, make_joint_seg_step,
                                       make_optimizer)

    n_class, shape = 4, (1, 12, 12, 16)
    rng = np.random.RandomState(230)
    torch.manual_seed(0)
    seg = UNetTemplate(encoders=((4, 8), (8, 8, 16)),
                       decoders=((16, 8, 8),), act="LeakyReLU", in_channel=1,
                       n_classes=n_class, bias=True, BN=True).to(cuda)
    reg = VoxelMorphCVPR2018(enc_filters=(4, 8, 8, 8, 8),
                             dec_filters=(8, 8, 8, 4, 4)).to(cuda)
    init = {k: v.clone() for k, v in seg.state_dict().items()}
    reg_init = {k: v.clone() for k, v in reg.state_dict().items()}
    images = [torch.from_numpy(rng.rand(*shape, 1).astype(np.float32)).to(
        cuda) for _ in range(2)]
    labels = [torch.from_numpy(rng.randint(0, n_class, shape)).to(cuda)
              for _ in range(2)]
    warp_fn = functools.partial(kernels.grid_sample, max_disp=2,
                                grad="values")
    sup = get_loss_function("dice")(n_class=n_class, weight_type="Uniform",
                                    no_bg=False, softmax=True, eps=1e-6)

    def run(hard_fused):
        seg.load_state_dict(init)
        state = TrainState(seg, make_optimizer(seg, 0.0))
        step = make_joint_seg_step(sup, 3.0, 1.0, n_class, warp_fn=warp_fn,
                                   hard_fused=hard_fused, max_disp=2)
        before = kernels.launch_counts()
        _, metrics = step(state, TrainState(reg, make_optimizer(reg, 0.0)),
                          *images, *labels, torch.tensor([flags[0]]),
                          torch.tensor([flags[1]]))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k] and k not in (
                        "conv3d_k3", "conv3d_k3_wgrad", "conv3d_point",
                        "deconv2x")}
        grads = {n: p.grad.clone() for n, p in seg.named_parameters()}
        return {k: float(v) for k, v in metrics.items()}, grads, launched

    metrics, grads, launched = run(True)
    assert launched == SEG_REGIME_LAUNCHES[flags]
    soft_metrics, soft_grads, _ = run(False)
    for key in metrics:
        assert abs(metrics[key] - soft_metrics[key]) <= 1e-5, key
    # a conv bias in front of a BatchNorm has no gradient (the batch mean
    # removes it): rounding noise only
    noise_only = {f"{name}.bias" for name, mod in seg.named_modules()
                  if getattr(mod, "bn", None) is not None}
    for name, g in grads.items():
        ref = soft_grads[name]
        if name not in noise_only:
            assert (g - ref).abs().max().item() \
                <= 1e-4 * ref.abs().max().item(), name
    for k, v in reg.state_dict().items():
        assert torch.equal(v, reg_init[k]), k
    assert all(p.grad is None for p in reg.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [((1, 7, 9, 33), 1, 8),
                                            ((2, 10, 13, 40), 48, 16),
                                            ((1, 12, 5, 21), 16, 72),
                                            ((1, 21, 25, 21), 64, 64),
                                            ((1, 3, 8, 40), 96, 5)])
@pytest.mark.parametrize("p_blk", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_conv_matches_plain_on_card(cuda, shape, cin, cout, p_blk,
                                          dtype):
    """Kernel K at every p_blk (every template instantiation), depths that
    are not a multiple of it (the tail block), ragged (y, x) tiles, batch 2,
    one input channel, Cout that fills its last channel block only partly
    and Cout that is not a multiple of 8 (scalar stores): against its plain
    version and against kernel A, the same function, each within the
    tolerances of the other conv tests."""
    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_block,
                                         conv3d_k3_block_plain)

    rng = np.random.RandomState(230)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, dtype)
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) * 0.2).astype(
        np.float32)).to(cuda)
    before = conv3d_k3_block.launches
    got = conv3d_k3_block(x, w, p_blk=p_blk)
    ref = conv3d_k3_block_plain(x, w, p_blk=p_blk)
    a = conv3d_k3(x, w)
    torch.cuda.synchronize()
    assert conv3d_k3_block.launches == before + 1
    assert got.shape == shape + (cout,) and got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for other in (ref, a):
        err = (got.float() - other.float()).abs().max().item()
        assert err <= tol * other.float().abs().max().item()


@pytest.mark.cuda
def test_block_conv_raises_on_card(cuda):
    from deepatlas_torch.kernels import conv3d_k3_block

    x = torch.zeros(1, 4, 4, 4, 8, device=cuda)
    w = torch.zeros(3, 3, 3, 8, 8, device=cuda)
    for p_blk in (0, 9):
        with pytest.raises(ValueError, match="p_blk"):
            conv3d_k3_block(x, w, p_blk=p_blk)
    with pytest.raises(RuntimeError, match="forward only"):
        conv3d_k3_block(x, w.clone().requires_grad_())
    with pytest.raises(ValueError, match="operands on"):
        conv3d_k3_block(x, w.cpu())


# ------------------------------------------- tensor-core kernels (bfloat16)
# Channel counts of the four paths' edges (the 1- and 2-channel entry
# convs, VoxelMorph's 3-channel flow head, the decoders' 24, 48 and 96
# channels after a concatenation, UNet_light's widest 128 and 64) and a
# Cout above one 64-channel block (72); widths 21, 25, 42, 50 and 84 leave
# a ragged last 16-wide tile, and odd depths and heights a ragged tile in
# every axis.
MMA_CASES = [((1, 5, 7, 21), 1, 8), ((2, 6, 9, 25), 2, 16),
             ((1, 4, 6, 42), 24, 3), ((1, 3, 5, 50), 96, 32),
             ((1, 3, 4, 84), 128, 64), ((1, 5, 3, 20), 48, 72),
             ((1, 7, 6, 9), 3, 24)]


def _bf16_inputs(cuda, shape, cin, cout, stride, seed=230):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout)
                          / np.sqrt(27 * cin)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(cuda)
    out_shape = (shape[0],) + tuple(-(-n // stride) for n in shape[1:])
    g = torch.from_numpy(rng.randn(*out_shape, cout).astype(np.float32)).to(
        cuda, torch.bfloat16)
    return x, w, b, g


def _close(got, ref, tol):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", MMA_CASES)
@pytest.mark.parametrize("stride", [1, 2])
def test_mma_conv_and_input_grad_match_plain_on_card(cuda, shape, cin, cout,
                                                     stride):
    """Kernel A in bfloat16 (tensor cores): the forward with its bias and
    the input gradient, at stride 1 and 2, against the plain versions
    (one bf16 rounding: 1e-2 of the range), one launch each; the strided
    input gradient never builds a zero-stuffed tensor (its parity-class
    launch reads the gradient as it is)."""
    from unittest import mock

    from deepatlas_torch.kernels import (conv3d, conv3d_k3,
                                         conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain,
                                         conv3d_k3_plain)

    x, w, b, g = _bf16_inputs(cuda, shape, cin, cout, stride)
    before = conv3d_k3.launches
    got = conv3d_k3(x, w, b, stride=stride)
    torch.cuda.synchronize()
    assert conv3d_k3.launches == before + 1
    _close(got, conv3d_k3_plain(x, w, b, stride=stride), 1e-2)

    def no_zero_tensor(grad, dhw, s, pad_d=1):
        assert s == 1, "the strided input gradient built a zero-stuffed one"
        return grad

    before = conv3d_k3.launches
    with mock.patch.object(conv3d, "zero_stuffed", no_zero_tensor):
        dx = conv3d_k3_input_grad(g, w, shape[1:], stride)
        torch.cuda.synchronize()
    assert conv3d_k3.launches == before + 1
    _close(dx, conv3d_k3_input_grad_plain(g, w, shape[1:], stride), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", MMA_CASES)
@pytest.mark.parametrize("stride", [1, 2])
def test_mma_wgrad_matches_plain_on_card(cuda, shape, cin, cout, stride):
    """Kernel D in bfloat16 (tensor cores) at stride 1 and 2 against its
    plain version: both sum the same exact bf16 products in float32, so
    1e-4 of the largest entry holds; one launch per call, and two runs
    equal bit for bit (fixed-order sums, no atomics)."""
    x, _, _, g = _bf16_inputs(cuda, shape, cin, cout, stride)
    before = conv3d_k3_wgrad.launches
    got = conv3d_k3_wgrad(x, g, stride)
    again = conv3d_k3_wgrad(x, g, stride)
    torch.cuda.synchronize()
    assert conv3d_k3_wgrad.launches == before + 2
    assert torch.equal(got, again)
    _close(got, conv3d_k3_wgrad_plain(x, g, stride), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout,stride", [
    ((1, 42, 50, 42), 128, 64, 1), ((1, 84, 100, 84), 96, 32, 1),
    ((1, 168, 200, 168), 2, 16, 2), ((1, 84, 100, 84), 16, 32, 2)])
def test_mma_kernels_at_full_width_on_card(cuda, shape, cin, cout, stride):
    """The tensor-core kernels at full-width shapes of UNet_light and of
    VoxelMorph's encoder: forward, input gradient and weight gradient
    against the plain versions."""
    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain,
                                         conv3d_k3_plain)

    x, w, b, g = _bf16_inputs(cuda, shape, cin, cout, stride)
    _close(conv3d_k3(x, w, b, stride=stride),
           conv3d_k3_plain(x, w, b, stride=stride), 1e-2)
    _close(conv3d_k3_input_grad(g, w, shape[1:], stride),
           conv3d_k3_input_grad_plain(g, w, shape[1:], stride), 1e-2)
    _close(conv3d_k3_wgrad(x, g, stride),
           conv3d_k3_wgrad_plain(x, g, stride), 1e-4)


@pytest.mark.cuda
def test_mma_wgrad_is_bit_identical_at_full_size_on_card(cuda):
    """Two bf16 weight gradients of UNet_light's 16 -> 16 conv on the whole
    168x200x168 volume are equal bit for bit."""
    x, _, _, g = _bf16_inputs(cuda, (1, 168, 200, 168), 16, 16, 1)
    first = conv3d_k3_wgrad(x, g)
    second = conv3d_k3_wgrad(x, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_follow_the_type_on_card(cuda, dtype):
    """bfloat16 launches the tensor-core kernels of conv3d_mma.cu, float32
    the CUDA-core kernels of conv3d.cu and conv3d_wgrad.cu: one launch per
    call either way."""
    from unittest import mock

    from deepatlas_torch.kernels import conv3d, conv3d_k3

    x, w, b, g = _bf16_inputs(cuda, (1, 5, 6, 20), 16, 8, 1)
    x, g = x.to(dtype), g.to(dtype)
    want = "mma" if dtype == torch.bfloat16 else "simt"
    with mock.patch.object(conv3d, "_k3_mma", wraps=conv3d._k3_mma) as km, \
            mock.patch.object(conv3d, "_k3_simt",
                              wraps=conv3d._k3_simt) as ks, \
            mock.patch.object(conv3d, "_wgrad_mma",
                              wraps=conv3d._wgrad_mma) as wm, \
            mock.patch.object(conv3d, "_wgrad_simt",
                              wraps=conv3d._wgrad_simt) as ws:
        conv3d_k3(x, w, b)
        conv3d_k3_wgrad(x, g)
        torch.cuda.synchronize()
        seen = {"mma": (km.call_count, wm.call_count),
                "simt": (ks.call_count, ws.call_count)}
    assert seen[want] == (1, 1)
    assert seen["simt" if want == "mma" else "mma"] == (0, 0)


# Kernels C and B in bfloat16 (csrc/channel_mix_mma.cu): every shape the
# main paths launch them at -- UNet_light's decoder upsamples and head (and
# the head's input gradient) on a 168x200x168 volume and on a serving batch
# of 4 x 128^3 tiles, VoxelMorph's identity-bank upsample -- and small odd
# shapes with every narrow and wide channel count.
MIX_MAIN_SHAPES = [
    ("deconv2x", (1, 21, 25, 21), 64, 64),
    ("deconv2x", (1, 42, 50, 42), 64, 64),
    ("deconv2x", (1, 84, 100, 84), 32, 32),
    ("deconv2x", (4, 16, 16, 16), 64, 64),
    ("deconv2x", (4, 32, 32, 32), 64, 64),
    ("deconv2x", (4, 64, 64, 64), 32, 32),
    ("deconv2x", (1, 84, 100, 84), 8, 8),
    ("conv3d_point", (1, 168, 200, 168), 16, 32),
    ("conv3d_point", (1, 168, 200, 168), 32, 16),
    ("conv3d_point", (4, 128, 128, 128), 16, 5)]
MIX_ODD = [(cin, cout) for cin in (1, 3, 8, 16, 32, 48, 64)
           for cout in (1, 5, 8, 16, 32, 64)] + [(16, 72), (8, 136), (96, 72)]


def _mix_check(cuda, name, shape, cin, cout):
    """One bf16 launch with a bias against the plain version (one bf16
    rounding: 1e-2 of the range), and a rerun equal bit for bit (each
    output is one voxel's fixed-order sum, no atomics)."""
    fn, plain = KERNELS[name]
    rng = np.random.RandomState(230)
    lead = (2, 2, 2) if name == "deconv2x" else ()
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(*lead, cin, cout) / np.sqrt(cin)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(cuda)
    before = fn.launches
    got = fn(x, w, b)
    again = fn(x, w, b)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    _close(got, plain(x, w, b), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,cin,cout", MIX_MAIN_SHAPES)
def test_mix_kernels_at_main_path_shapes_on_card(cuda, name, shape, cin,
                                                 cout):
    _mix_check(cuda, name, shape, cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deconv2x", "conv3d_point"])
@pytest.mark.parametrize("cin,cout", MIX_ODD)
def test_mix_kernels_at_odd_shapes_on_card(cuda, name, cin, cout):
    """Batch 2, odd W, a ragged last tile with row, depth and batch breaks
    inside tiles; Cin that fills its 16-deep K chunk only partly or is not
    a multiple of 8 (scalar loads); Cout that is not a multiple of 8 (scalar
    stores) or spans several 64-channel blocks."""
    _mix_check(cuda, name, (2, 3, 5, 7), cin, cout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mix_kernels_follow_the_type_on_card(cuda, dtype):
    """bfloat16 launches the tensor-core kernel of channel_mix_mma.cu for
    the transposed conv, its identity-bank upsample and the 1x1x1 conv with
    its input gradient; float32 the CUDA-core kernels of channel_mix.cuh
    (through deconv3d.cu and conv3d.cu).  One launch per call either way."""
    from unittest import mock

    from deepatlas_torch.kernels import (conv3d, conv3d_point, deconv2x,
                                         deconv3d, nearest_up2x)

    rng = np.random.RandomState(230)
    x = torch.from_numpy(rng.randn(1, 3, 4, 5, 16).astype(np.float32)).to(
        cuda, dtype)
    w = torch.from_numpy(rng.randn(2, 2, 2, 16, 8).astype(np.float32)).to(
        cuda)
    wp = torch.from_numpy(rng.randn(16, 8).astype(np.float32)).to(cuda)
    with mock.patch.object(deconv3d, "_deconv_mma",
                           wraps=deconv3d._deconv_mma) as dm, \
            mock.patch.object(deconv3d, "_deconv_simt",
                              wraps=deconv3d._deconv_simt) as ds, \
            mock.patch.object(conv3d, "_point_mma",
                              wraps=conv3d._point_mma) as pm, \
            mock.patch.object(conv3d, "_point_simt",
                              wraps=conv3d._point_simt) as ps:
        deconv2x(x, w)
        nearest_up2x(x)
        xg = x.clone().requires_grad_()
        conv3d_point(xg, wp).float().sum().backward()
        torch.cuda.synchronize()
        seen = {"mma": (dm.call_count, pm.call_count),
                "simt": (ds.call_count, ps.call_count)}
    want = "mma" if dtype == torch.bfloat16 else "simt"
    assert seen[want] == (2, 2)
    assert seen["simt" if want == "mma" else "mma"] == (0, 0)


# --------------------------- kernel K on the tensor cores; F and G's ones

@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [((1, 7, 9, 33), 1, 3),
                                            ((2, 10, 13, 40), 16, 64),
                                            ((1, 12, 5, 21), 64, 72),
                                            ((1, 21, 25, 21), 64, 64)])
def test_mma_block_p_blk_2_is_a_and_reruns_on_card(cuda, shape, cin, cout):
    """Kernel K in bfloat16 runs on the tensor cores: at p_blk 2 it is
    kernel A's own instance, equal to ``conv3d_k3`` bit for bit; at every
    p_blk two calls give the same bits (no atomics) and match A within one
    bf16 rounding."""
    from deepatlas_torch.kernels import conv3d_k3, conv3d_k3_block

    rng = np.random.RandomState(232)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout)
                          / np.sqrt(27 * cin)).astype(np.float32)).to(cuda)
    a = conv3d_k3(x, w)
    for p_blk in range(1, 9):
        got = conv3d_k3_block(x, w, p_blk=p_blk)
        again = conv3d_k3_block(x, w, p_blk=p_blk)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if p_blk == 2:
            assert torch.equal(got, a)
        err = (got.float() - a.float()).abs().max().item()
        assert err <= 1e-2 * a.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("p_blk", [2, 4, 8])
def test_mma_block_at_full_width_on_card(cuda, p_blk):
    """K at UNet_light's widest 64-channel level (42x50x42), in bfloat16
    against its plain version."""
    from deepatlas_torch.kernels import conv3d_k3_block, conv3d_k3_block_plain

    gen = torch.Generator(device=cuda).manual_seed(233)
    x = (torch.rand((1, 42, 50, 42, 64), generator=gen, device=cuda) * 2
         - 1).to(torch.bfloat16)
    w = torch.randn((3, 3, 3, 64, 64), generator=gen, device=cuda) / 40.0
    got = conv3d_k3_block(x, w, p_blk=p_blk)
    ref = conv3d_k3_block_plain(x, w, p_blk=p_blk)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 8, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("amplitude", [2.0, 8.0])
def test_grid_grad_rerun_is_bit_identical_on_card(cuda, c, dtype, amplitude):
    """Kernel F has no atomics and adds a point's lanes in a fixed order:
    three calls give the same bits, in every layout (one thread a point at
    C = 1 and 2, 16-byte chunks a lane at 8 and 32, one thread a point at
    33), on a field of 2 voxels and one of noise up to 8; each matches the
    plain version within 1e-4 of its largest entry."""
    from deepatlas_torch import kernels

    shape = (2, 11, 14, 37)
    vol, grid, ct = _warp_inputs(cuda, shape, c, dtype, amplitude)
    outs = [kernels.warp_grid_grad(vol, grid, ct) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = kernels.warp_grid_grad_plain(vol, grid, ct)
    err = (outs[0] - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_grad_unaligned_and_odd_grids_on_card(cuda, dtype):
    """F where its fast layouts do not apply or their edges show: 32
    channels in tensors that are not 16-byte aligned (one thread a point),
    and one channel on a grid whose samples' point counts leave a block's
    coordinate records unaligned (batch 3 of 7x5x3 points: the 16-byte
    staging falls back to words)."""
    from deepatlas_torch import kernels

    shape = (1, 9, 10, 21)
    vol, grid, ct = _warp_inputs(cuda, shape, 33, dtype, 3.0)
    vol, ct = vol[..., 1:], ct[..., 1:]         # 32 channels, offset 1
    assert not vol.is_contiguous()
    vol, ct = (torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
               .view(t.shape).copy_(t) for t in (vol, ct))
    assert vol.data_ptr() % 16 and vol.is_contiguous()
    got = kernels.warp_grid_grad(vol, grid, ct)
    ref = kernels.warp_grid_grad_plain(vol, grid, ct)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    vol, grid, ct = _warp_inputs(cuda, (3, 6, 8, 10), 1, dtype, 0.0,
                                 out_shape=(7, 5, 3))
    got = kernels.warp_grid_grad(vol, grid, ct)
    ref = kernels.warp_grid_grad_plain(vol, grid, ct)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("amplitude", [2.5, 20.0])
def test_splat_ones_is_the_general_path_on_card(cuda, amplitude):
    """``splat_ones`` (no max pass, no cotangent read) gives the bits of
    ``splat_trilinear`` on a tensor of ones, again on a rerun, counted as
    one launch of G; batch 2, a clamped field."""
    from deepatlas_torch import kernels
    from deepatlas_torch.ops import clamp_displacement

    shape = (2, 13, 17, 30)
    _, grid, _ = _warp_inputs(cuda, shape, 1, torch.float32, amplitude)
    grid = clamp_displacement(grid, 8).contiguous()
    before = kernels.splat_trilinear.launches
    got = kernels.splat_ones(grid, shape[1:])
    assert kernels.splat_trilinear.launches == before + 1
    again = kernels.splat_ones(grid, shape[1:])
    ref = kernels.splat_trilinear(torch.ones(*shape, 1, device=cuda), grid,
                                  shape[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, ref)


@pytest.mark.cuda
def test_binned_sum_repeats_on_card(cuda):
    """The anatomy dice's per-class sums: the same bits again and with the
    elements in another order (int64 atomics), within 1e-6 of float64."""
    from deepatlas_torch.kernels import binned_sum

    gen = torch.Generator(device=cuda).manual_seed(234)
    lab = torch.randint(-1, 34, (1, 40, 50, 60), generator=gen, device=cuda)
    vals = torch.rand(lab.shape, generator=gen, device=cuda)
    got = binned_sum(vals, lab, 32)
    order = torch.randperm(lab.numel(), generator=gen, device=cuda)
    assert torch.equal(got, binned_sum(vals, lab, 32))
    assert torch.equal(got, binned_sum(vals.reshape(-1)[order],
                                       lab.reshape(-1)[order], 32))
    keep = (lab >= 0) & (lab < 32)
    exact = torch.zeros(32, dtype=torch.float64, device=cuda).index_add_(
        0, lab[keep], vals[keep].double())
    assert ((got.double() - exact).abs().max() / exact.abs().max()).item() \
        <= 1e-6


# the fixed UNet's widest kernel shapes at small spatial sizes: A and D at
# the decoder's concatenations (Cin 768 and 384), C at the 512-channel
# up-conv (8 output channels a block fit the channel mix's shared memory at
# Cin 512), B at the head's input width
UNET_WIDE_K3 = [((1, 5, 6, 7), 768, 256), ((1, 6, 5, 9), 384, 128)]
UNET_WIDE_MIX = [("deconv2x", (2, 2, 2), (1, 3, 4, 5), 512, 512),
                 ("conv3d_point", (), (2, 6, 8, 10), 64, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", UNET_WIDE_K3)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_wide_k3_kernels_on_card(cuda, shape, cin, cout, dtype):
    """A (forward and input gradient) and D at the fixed UNet's widest
    convs, in both types, against the plain versions."""
    from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_input_grad,
                                         conv3d_k3_input_grad_plain,
                                         conv3d_k3_plain)

    x, w, b, g = _bf16_inputs(cuda, shape, cin, cout, 1)
    x, g = x.to(dtype), g.to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    before = conv3d_k3.launches
    _close(conv3d_k3(x, w, b), conv3d_k3_plain(x, w, b), tol)
    _close(conv3d_k3_input_grad(g, w, shape[1:]),
           conv3d_k3_input_grad_plain(g, w, shape[1:]), tol)
    assert conv3d_k3.launches == before + 2
    got = conv3d_k3_wgrad(x, g)
    assert torch.equal(got, conv3d_k3_wgrad(x, g))
    _close(got, conv3d_k3_wgrad_plain(x, g), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name,wlead,shape,cin,cout", UNET_WIDE_MIX)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_wide_channel_mix_on_card(cuda, name, wlead, shape, cin, cout,
                                       dtype):
    """C at 512 -> 512 and B at 64 -> 32 launch (no "Cin too wide") and
    match their plain versions, the same bits on a rerun."""
    rng = np.random.RandomState(231)
    fn, plain = KERNELS[name]
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(
        cuda, dtype)
    w = torch.from_numpy((rng.randn(*wlead, cin, cout)
                          / np.sqrt(cin)).astype(np.float32)).to(cuda)
    bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(
        cuda)
    before = fn.launches
    got = fn(x, w, bias)
    assert fn.launches == before + 1
    assert torch.equal(got, fn(x, w, bias))
    _close(got, plain(x, w, bias), 1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_native_reader_matches_the_python_parser_on_card_host(cuda,
                                                              tmp_path):
    """The native I/O tier builds on the card's host and reads the bits the
    Python parser reads, images and labels."""
    from deepatlas_torch.data import (_native, read_counts, read_nifti,
                                      reset_read_counts, write_nifti)

    assert _native.available(), _native.build_error
    rng = np.random.RandomState(232)
    img = rng.rand(11, 13, 17).astype(np.float32)
    seg = rng.randint(0, 32, (11, 13, 17)).astype(np.uint8)
    reset_read_counts()
    for name, data in (("img.nii.gz", img), ("seg.nii.gz", seg)):
        write_nifti(tmp_path / name, data)
        native = read_nifti(tmp_path / name)
        python = read_nifti(tmp_path / name, prefer_native=False)
        assert native.data.dtype == np.float32
        assert np.array_equal(native.data, python.data.astype(np.float32))
        assert native.spacing == python.spacing
    assert read_counts() == {"native": 2, "fallback": 0}
