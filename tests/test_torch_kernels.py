"""deepatlas_torch kernels against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel it replaces (interpret mode, the way
tests/test_packed_conv.py runs it), or against ``lax`` / flax where the
packed kernel refuses a channel count.  The same numpy inputs go to both
packages.  float32 throughout: the point is the algorithm, and both sides
sum the same products in float32 (conftest pins JAX to full precision), so
1e-5 absolute holds at these O(1) outputs.

The CUDA kernels against their plain versions on the card are in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from deepatlas_tpu.pallas.conv3d import (pack_channels, packed_conv3d,
                                         packed_width, unpack_channels)
from deepatlas_tpu.pallas.deconv3d import deconv_w_blk, packed_deconv2x
from deepatlas_torch.kernels import (KERNELS, conv3d_k3, conv3d_point,
                                     deconv2x, launch_counts,
                                     reset_launch_counts)

DHW = (6, 8, 16)
PAIRS = [(8, 16), (16, 32), (32, 16)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(rng, shape, scale=1.0):
    return (rng.rand(*shape) if scale is None
            else rng.randn(*shape) * scale).astype(np.float32)


def packed_jax(x, k):
    """The Pallas packed conv (k3 or 1x1x1) in interpret mode."""
    c_in, c_out = k.shape[-2], k.shape[-1]
    w = x.shape[3]
    xp = pack_channels(jnp.asarray(x), packed_width(w, c_in, c_out))[0]
    out = packed_conv3d(xp, jnp.asarray(k), c_in=c_in, w_valid=w,
                        kernel_size=k.shape[0], interpret=True)
    return np.asarray(unpack_channels(out[None], c_out, w))


def lax_conv(x, k):
    pad = [(1, 1)] * 3 if k.shape[0] == 3 else [(0, 0)] * 3
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1, 1), pad,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))


def t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_conv3d_k3_matches_packed_pallas(rng, cin, cout):
    x = make(rng, (1,) + DHW + (cin,), None)
    k = make(rng, (3, 3, 3, cin, cout), 0.1)
    out = conv3d_k3(t(x), t(k)).numpy()
    np.testing.assert_allclose(out, packed_jax(x, k), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout", [(1, 8), (48, 16), (96, 32), (128, 64)])
def test_conv3d_k3_unpackable_channels_match_lax(rng, cin, cout):
    """Channel counts the packed kernel refuses (not powers of two, or the
    1-channel input the JAX model zero-pads to 8) -- the port takes them
    as they are."""
    x = make(rng, (2, 4, 6, 8, cin), None)
    k = make(rng, (3, 3, 3, cin, cout), 1.0 / np.sqrt(27 * cin))
    out = conv3d_k3(t(x), t(k)).numpy()
    np.testing.assert_allclose(out, lax_conv(x, k), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout", PAIRS + [(16, 5)])
def test_conv3d_point_matches(rng, cin, cout):
    x = make(rng, (1,) + DHW + (cin,), None)
    k = make(rng, (1, 1, 1, cin, cout), 0.2)
    bias = make(rng, (cout,), 0.1)
    # the packed kernel needs power-of-two Cout: hold 16 -> 5 against lax
    ref = packed_jax(x, k) if cout & (cout - 1) == 0 else lax_conv(x, k)
    np.testing.assert_allclose(conv3d_point(t(x), t(k)).numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(conv3d_point(t(x), t(k[0, 0, 0]),
                                            t(bias)).numpy(), ref + bias,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cin,cout", PAIRS)
def test_deconv2x_matches_packed_pallas_and_flax(rng, cin, cout):
    """First direct check of packed_deconv2x's (2,2,2,I,O) layout, and of
    the standard tree's flax ConvTranspose with the (2,2,2,O,I) kernel."""
    x = make(rng, (1,) + DHW + (cin,), None)
    k = make(rng, (2, 2, 2, cin, cout), 0.2)
    out = deconv2x(t(x), t(k)).numpy()

    w = DHW[2]
    assert w % deconv_w_blk(cin, cout) == 0
    xp = pack_channels(jnp.asarray(x), w)[0]
    pk = packed_deconv2x(xp, jnp.asarray(k), c_in=cin, w_valid_out=2 * w,
                         interpret=True)
    ref_packed = np.asarray(unpack_channels(pk[None], cout, 2 * w))
    np.testing.assert_allclose(out, ref_packed, atol=1e-5, rtol=1e-5)

    flax_deconv = nn.ConvTranspose(cout, (2, 2, 2), strides=(2, 2, 2),
                                   padding="VALID", use_bias=False,
                                   transpose_kernel=True)
    ref_flax = np.asarray(flax_deconv.apply(
        {"params": {"kernel": jnp.asarray(k.transpose(0, 1, 2, 4, 3))}},
        jnp.asarray(x)))
    np.testing.assert_allclose(out, ref_flax, atol=1e-5, rtol=1e-5)


def test_bias_and_bf16_rounding(rng):
    """bias adds in float32 before the single rounding to the input type;
    weights round to the input type first."""
    x = make(rng, (1, 4, 4, 8, 8), None)
    k = make(rng, (3, 3, 3, 8, 4), 0.1)
    bias = make(rng, (4,), 1.0)
    ref = lax_conv(x, k) + bias
    got = conv3d_k3(t(x), t(k), t(bias)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    xb = t(x).to(torch.bfloat16)
    kb = t(k).to(torch.bfloat16).float().numpy()
    ref_b = lax_conv(xb.float().numpy(), kb) + bias
    got_b = conv3d_k3(xb, t(k), t(bias))
    assert got_b.dtype == torch.bfloat16
    # one rounding of the same float32 sum: equal up to a rounding flip
    # where the two summation orders straddle a bf16 tie (one ulp, 2^-7)
    np.testing.assert_allclose(
        got_b.float().numpy(),
        torch.from_numpy(ref_b).to(torch.bfloat16).float().numpy(),
        rtol=2 ** -7, atol=1e-6)


def test_cpu_tensors_take_the_plain_path(rng):
    reset_launch_counts()
    x = t(make(rng, (1, 2, 4, 4, 8), None))
    conv3d_k3(x, t(make(rng, (3, 3, 3, 8, 8), 0.1)))
    conv3d_point(x, t(make(rng, (8, 3), 0.1)))
    deconv2x(x, t(make(rng, (2, 2, 2, 8, 4), 0.1)))
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_wrappers_reject_bad_operands(rng):
    x = t(make(rng, (1, 2, 4, 4, 8), None))
    with pytest.raises(ValueError, match="w must be"):
        conv3d_k3(x, torch.zeros(3, 3, 3, 4, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3d_k3(x.double(), torch.zeros(3, 3, 3, 8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        deconv2x(x.transpose(2, 3), torch.zeros(2, 2, 2, 8, 8))
    with pytest.raises(ValueError, match="bias must be"):
        conv3d_point(x, torch.zeros(8, 3), torch.zeros(4))
