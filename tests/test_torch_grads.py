"""Gradients of the deepatlas_torch conv wrappers against the JAX package.

Each wrapper is a ``torch.autograd.Function``; on the CPU its backward runs
through the same wrappers the card uses and reaches their plain versions.
The same numpy inputs and the same cotangent go to ``jax.grad`` of the
Pallas packed ops in interpret mode (power-of-two channels, the way
tests/test_packed_conv.py::test_grads_match_xla runs them) or of
``lax.conv_general_dilated`` (channel counts the packed kernels refuse).

Tolerances: float32 differs only in summation order, and a weight gradient
sums over every voxel, so it is held to 1e-5 of the largest entry (the
wrappers' ``dx`` to 1e-5 absolute and relative at O(1) values).  bfloat16:
both sides round x, w and the cotangent to bf16 and accumulate in float32,
so ``dW``/``db`` agree to float32 summation order and ``dx`` to one final
bf16 rounding; 2e-2 of the largest entry covers both.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deepatlas_tpu.pallas.conv3d import (pack_channels, packed_conv3d,
                                         packed_width, unpack_channels)
from deepatlas_tpu.pallas.deconv3d import deconv_w_blk, packed_deconv2x
from deepatlas_torch.kernels import (conv3d_k3, conv3d_k3_wgrad,
                                     conv3d_k3_wgrad_plain, conv3d_point,
                                     deconv2x)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(rng, shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def packed_conv(x, k):
    """The Pallas packed conv (k3 or 1x1x1), interpret mode, on NDHWC."""
    c_in, c_out = k.shape[-2], k.shape[-1]
    w = x.shape[3]
    xp = pack_channels(x, packed_width(w, c_in, c_out))[0]
    out = packed_conv3d(xp, k, c_in=c_in, w_valid=w, kernel_size=k.shape[0],
                        interpret=True)
    return unpack_channels(out[None], c_out, w)


def lax_conv(x, k):
    """XLA's conv on the (already rounded) operands widened to float32, so
    that products accumulate in float32 as in the kernels; the output is
    rounded to x's type once."""
    pad = [(1, 1)] * 3 if k.shape[0] == 3 else [(0, 0)] * 3
    return jax.lax.conv_general_dilated(
        x.astype(jnp.float32), k.astype(jnp.float32), (1, 1, 1), pad,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")).astype(x.dtype)


def packed_deconv(x, k):
    c_in, c_out = k.shape[-2], k.shape[-1]
    w = x.shape[3]
    assert w % deconv_w_blk(c_in, c_out) == 0
    out = packed_deconv2x(pack_channels(x, w)[0], k, c_in=c_in,
                          w_valid_out=2 * w, interpret=True)
    return unpack_channels(out[None], c_out, 2 * w)


def jax_grads(op, x, k, bias, ct, dtype):
    """(dx, dk, db) of ``sum(op(x, k) + bias) * ct`` with x and the
    cotangent in ``dtype`` and float32 parameters cast to it, as the JAX
    modules do."""
    def loss(x, k, bias):
        y = op(x.astype(dtype), k.astype(dtype))
        # the bias and the sum in float32: db is then the float32 sum of
        # the cotangent, free of the reference's own bf16 accumulation
        y = y.astype(jnp.float32) + bias
        return jnp.sum(y * ct.astype(dtype).astype(jnp.float32))

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(bias))
    return [np.asarray(a, dtype=np.float32) for a in g]


def torch_grads(fn, x, k, bias, ct, dtype, fused_bias=True,
                sliced_cotangent=False):
    """The same through the port's wrapper.  ``sliced_cotangent`` makes the
    upstream gradient a channel slice of a wider tensor, as the backward of
    ``torch.cat`` hands it to a decoder conv."""
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    if fused_bias:
        y = fn(xt, kt, bt)
    else:
        y = fn(xt, kt) + bt.to(dtype)
    ctt = torch.from_numpy(ct).to(dtype)
    if sliced_cotangent:
        wide = torch.zeros(ct.shape[:-1] + (ct.shape[-1] + 3,), dtype=dtype)
        wide[..., 1:-2] = ctt
        ctt = wide[..., 1:-2]
        assert not ctt.is_contiguous()
    y.backward(ctt)
    assert xt.grad.dtype == dtype
    assert kt.grad.dtype == torch.float32 and bt.grad.dtype == torch.float32
    return [t.grad.float().numpy() for t in (xt, kt, bt)]


def assert_close(got, ref, tol, what):
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(got - ref).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


DTYPES = [(torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16,
                                               2e-2)]


@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES,
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("ksize,cin,cout", [(3, 8, 16), (3, 16, 16),
                                            (1, 16, 32), (1, 32, 16)])
def test_conv_grads_match_packed_pallas(rng, ksize, cin, cout, tdtype,
                                        jdtype, tol):
    """k3 and 1x1x1: dx, dW, db against jax.grad of packed_conv3d
    (interpret mode), odd depth and height."""
    shape = (1, 5, 7, 16)
    x = make(rng, shape + (cin,))
    k = make(rng, (ksize,) * 3 + (cin, cout), 0.2)
    bias = make(rng, (cout,), 0.1)
    ct = make(rng, shape + (cout,))
    fn = conv3d_k3 if ksize == 3 else conv3d_point
    ref = jax_grads(packed_conv, x, k, bias, ct, jdtype)
    got = torch_grads(fn, x, k, bias, ct, tdtype)
    for name, a, b in zip(("dx", "dW", "db"), got, ref):
        assert_close(a, b, tol, name)


@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES,
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout,shape", [(1, 8, (2, 5, 7, 9)),
                                            (48, 16, (1, 3, 5, 7)),
                                            (96, 32, (1, 4, 3, 5))])
def test_conv_k3_grads_match_lax_any_channels(rng, cin, cout, shape, tdtype,
                                              jdtype, tol):
    """Channel counts the packed kernel refuses, all-odd volumes, batch 2,
    and a non-contiguous upstream gradient; the bias added outside the
    wrapper, as the model's blocks add it."""
    x = make(rng, shape + (cin,))
    k = make(rng, (3, 3, 3, cin, cout), 1.0 / np.sqrt(27 * cin))
    bias = make(rng, (cout,), 0.1)
    ct = make(rng, shape + (cout,))
    ref = jax_grads(lax_conv, x, k, bias, ct, jdtype)
    got = torch_grads(conv3d_k3, x, k, bias, ct, tdtype, fused_bias=False,
                      sliced_cotangent=True)
    for name, a, b in zip(("dx", "dW", "db"), got, ref):
        assert_close(a, b, tol, name)


@pytest.mark.parametrize("tdtype,jdtype,tol", DTYPES,
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 16)])
def test_deconv_grads_match_packed_pallas(rng, cin, cout, tdtype, jdtype,
                                          tol):
    shape = (1, 3, 5, 8)
    x = make(rng, shape + (cin,))
    k = make(rng, (2, 2, 2, cin, cout), 0.2)
    bias = make(rng, (cout,), 0.1)
    ct = make(rng, (1, 6, 10, 16, cout))
    ref = jax_grads(packed_deconv, x, k, bias, ct, jdtype)
    got = torch_grads(deconv2x, x, k, bias, ct, tdtype,
                      sliced_cotangent=True)
    for name, a, b in zip(("dx", "dW", "db"), got, ref):
        assert_close(a, b, tol, name)


@pytest.mark.parametrize("cin,cout,shape", [(1, 8, (2, 5, 7, 9)),
                                            (48, 16, (1, 3, 5, 7)),
                                            (8, 5, (1, 21, 3, 25))])
def test_wgrad_plain_matches_torch_autograd_of_conv3d(rng, cin, cout, shape):
    """A second oracle for the plain weight gradient: torch autograd through
    ``F.conv3d`` (float64, so the reference carries no rounding of its
    own)."""
    x = make(rng, shape + (cin,))
    g = make(rng, shape + (cout,))
    w = torch.zeros(cout, cin, 3, 3, 3, dtype=torch.float64,
                    requires_grad=True)
    y = F.conv3d(torch.from_numpy(x).double().permute(0, 4, 1, 2, 3), w,
                 padding=1)
    y.backward(torch.from_numpy(g).double().permute(0, 4, 1, 2, 3))
    ref = w.grad.permute(2, 3, 4, 1, 0).float().numpy()
    for fn in (conv3d_k3_wgrad, conv3d_k3_wgrad_plain):
        got = fn(torch.from_numpy(x), torch.from_numpy(g))
        assert got.shape == (3, 3, 3, cin, cout)
        assert got.dtype == torch.float32
        assert_close(got.numpy(), ref, 1e-5, fn.__name__)


def test_wgrad_rejects_bad_operands(rng):
    x = torch.zeros(1, 2, 4, 4, 8)
    with pytest.raises(ValueError, match="share their voxels"):
        conv3d_k3_wgrad(x, torch.zeros(1, 2, 4, 5, 8))
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        conv3d_k3_wgrad(x, torch.zeros(1, 2, 4, 4, 8).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        conv3d_k3_wgrad(x, torch.zeros(1, 2, 4, 4, 16)[..., ::2])


def test_no_grad_and_frozen_weights(rng):
    """Under ``no_grad`` nothing is recorded; with frozen weights only dx
    flows (the 13 of 14 dx launches of a training step are this branch
    taken the other way round: the first conv's input needs no dx)."""
    x = torch.from_numpy(make(rng, (1, 3, 4, 5, 8))).requires_grad_()
    w = torch.from_numpy(make(rng, (3, 3, 3, 8, 4), 0.2))
    with torch.no_grad():
        assert not conv3d_k3(x, w).requires_grad
    y = conv3d_k3(x, w)
    y.sum().backward()
    assert x.grad is not None and w.grad is None
    w.requires_grad_()
    y = conv3d_k3(x.detach(), w)
    y.sum().backward()
    assert w.grad.shape == w.shape
