"""deepatlas_torch CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Shapes are chosen to reach every edge of the kernels: a 1-channel input,
widths that are not multiples of the 32-wide tile, Cout that is not a
multiple of 8 (scalar stores) and Cout above one 32-channel block.
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
