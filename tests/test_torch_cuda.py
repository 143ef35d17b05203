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

from deepatlas_torch.kernels import KERNELS


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
