"""The layout and index math of the tensor-core conv kernels, on the CPU.

The bfloat16 kernels of ``deepatlas_torch/kernels/csrc/conv3d_mma.cu`` run
only on the card (``tests/test_torch_cuda.py`` holds them there); what they
rely on is arithmetic that the CPU can check, done here in torch the way
the kernels do it:

* the conv as an implicit GEMM: columns ``tap * CP + ci`` of the shifted
  input (``tap = kz*9 + ky*3 + kx``, channels padded by zeros to
  ``CP = ceil(Cin / 8) * 8``, the K dimension padded to a multiple of 16)
  times the ``(K_pad, NP)`` matrix of ``pack_k3_weights``; the stride-1
  ``dx`` the same GEMM on the upstream gradient with the adjoint weights;
* the strided conv's ``dx`` by parity class (``parity_tap_table``): input
  voxel ``2q + p`` sums, over its class's taps ``k``, the gradient at
  ``q + (p + 1 - k) // 2`` (zero past the end) times row ``26 - tap`` of the
  packed adjoint weights, which is what the kernel reads;
* the weight gradient as the GEMM ``im2col(x)^T g`` over the voxels.

Each is held against the plain versions (``_k3_math``, the zero-stuffed
``dx``, ``_wgrad_math``) and, in float32, against the JAX package: its
packed Pallas conv in interpret mode where it packs the channels (powers of
two), else ``lax.conv_general_dilated`` and ``jax.vjp`` of it.  The same
numpy inputs go to both packages.  Tolerances, relative to the output's
largest entry: float32 1e-5 (the same float32 products summed in another
order); bfloat16 1e-2 for the conv and ``dx`` (one rounding of the output),
1e-5 for the weight gradient (float32 out of exact bf16 products).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deepatlas_tpu.pallas.conv3d import (pack_channels, packed_conv3d,
                                         packed_width, unpack_channels)
from deepatlas_torch.kernels import (conv3d, conv3d_k3, conv3d_k3_input_grad,
                                     conv3d_k3_input_grad_plain,
                                     conv3d_k3_wgrad, pack_k3_weights,
                                     parity_tap_table)
from deepatlas_torch.kernels.conv3d import (_dx_math, _k3_math, _wgrad_math,
                                            adjoint_k3_weights,
                                            strided_shape)

# Cin, Cout in {1, 2, 3, 8, 24, 48} on both sides, odd sizes, batch 2
CASES = [((1, 5, 7, 9), 1, 8), ((2, 3, 5, 6), 2, 3), ((1, 4, 5, 7), 3, 24),
         ((1, 5, 3, 6), 8, 48), ((1, 3, 6, 5), 24, 1), ((1, 4, 4, 5), 48, 2)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def operands(shape, cin, cout, stride, seed=230):
    """numpy x (the conv's input), w, bias and g (an upstream gradient of
    the strided output's shape); w holds bfloat16 values, as the packed
    weights do, so that float32 checks of the layout are exact."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(
        27 * cin)).astype(np.float32)).bfloat16().float().numpy()
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(shape[0], *strided_shape(shape[1:], stride), cout).astype(
        np.float32)
    return x, w, b, g


def rounded(a, dtype):
    """numpy -> torch in ``dtype``, and the same values in float32."""
    t = torch.from_numpy(a).to(dtype)
    return t, t.float()


def close(got, ref, tol):
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


def im2col(x, stride, k_pad):
    """``(voxels, K_pad)`` float32 columns of x in ``pack_k3_weights``'s K
    order: tap-major, channels padded to a multiple of 8, K to ``k_pad``."""
    b, d, h, w, cin = x.shape
    cp = -(-cin // 8) * 8
    xp = F.pad(x.float(), (0, cp - cin, 1, 1, 1, 1, 1, 1))
    do, ho, wo = strided_shape((d, h, w), stride)
    cols = [xp[:, kz:kz + stride * (do - 1) + 1:stride,
               ky:ky + stride * (ho - 1) + 1:stride,
               kx:kx + stride * (wo - 1) + 1:stride]
            for kz in range(3) for ky in range(3) for kx in range(3)]
    a = torch.cat(cols, dim=-1).reshape(-1, 27 * cp)
    return F.pad(a, (0, k_pad - 27 * cp)), (b, do, ho, wo)


def gemm_conv(x, wk, bias, stride):
    """The forward as the tensor-core kernel computes it: the packed
    weights, products and sums in float32, one rounding to x's type."""
    packed = pack_k3_weights(wk)
    cols, lead = im2col(x, stride, packed.shape[0])
    y = cols @ packed.float()
    y = y[:, :wk.shape[-1]]
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1).to(x.dtype)


def parity_dx(g, wk, dhw):
    """The stride-2 ``dx`` by parity class, as the kernel reads its
    operands: the gradient at ``q + (p + 1 - k) // 2`` and row ``26 - tap``
    of the packed adjoint weights."""
    packed = pack_k3_weights(adjoint_k3_weights(wk)).float()
    b, cg, cx = g.shape[0], g.shape[-1], wk.shape[-2]
    cp = -(-cg // 8) * 8
    gp = F.pad(g.float(), (0, cp - cg, 0, 1, 0, 1, 0, 1))
    dx = torch.zeros(b, *dhw, cx)
    for cls, taps in enumerate(parity_tap_table()):
        p = (cls >> 2, (cls >> 1) & 1, cls & 1)
        n = [(dhw[a] - p[a] + 1) // 2 for a in range(3)]
        acc = torch.zeros(b, *n, packed.shape[1])
        for tap in taps:
            k = (tap // 9, tap // 3 % 3, tap % 3)
            d = [(p[a] + 1 - k[a]) // 2 for a in range(3)]
            rows = packed[(26 - tap) * cp:(27 - tap) * cp]
            acc += gp[:, d[0]:d[0] + n[0], d[1]:d[1] + n[1],
                      d[2]:d[2] + n[2]] @ rows
        dx[:, p[0]::2, p[1]::2, p[2]::2] = acc[..., :cx]
    return dx.to(g.dtype)


def gemm_wgrad(x, g, stride):
    """dW as im2col(x)^T g over the voxels, in float32."""
    cin, cout = x.shape[-1], g.shape[-1]
    cp = -(-cin // 8) * 8
    cols, _ = im2col(x, stride, 27 * cp)
    dw = cols.t() @ g.float().reshape(-1, cout)
    return dw.reshape(27, cp, cout)[:, :cin].reshape(3, 3, 3, cin, cout)


def lax_conv(x, k, stride):
    return jax.lax.conv_general_dilated(
        x, k, (stride,) * 3, [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


def test_pack_k3_weights_layout():
    rng = np.random.RandomState(0)
    for cin, cout in [(1, 8), (3, 24), (8, 3), (24, 48), (48, 2), (16, 16)]:
        w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(
            np.float32)).to(torch.bfloat16).float()
        packed = pack_k3_weights(w)
        cp, npad = -(-cin // 8) * 8, -(-cout // 8) * 8
        assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
        assert packed.shape == (-(-27 * cp // 16) * 16, npad)
        body = packed[:27 * cp].float().reshape(3, 3, 3, cp, npad)
        assert torch.equal(body[..., :cin, :cout], w)
        assert not body[..., cin:, :].any() and not body[..., cout:].any()
        assert not packed[27 * cp:].any()


def test_parity_tap_table_covers_every_tap_once():
    table = parity_tap_table()
    assert len(table) == 8
    assert [len(t) for t in table] == [1, 2, 2, 4, 2, 4, 4, 8]
    assert sorted(t for taps in table for t in taps) == list(range(27))
    for cls, taps in enumerate(table):
        p = (cls >> 2, (cls >> 1) & 1, cls & 1)
        for tap in taps:
            k = (tap // 9, tap // 3 % 3, tap % 3)
            # input 2q + p meets output q + (p + 1 - k) / 2 exactly
            assert all((p[a] + 1 - k[a]) % 2 == 0 for a in range(3))
    arg = list(conv3d._tap_table_arg())
    assert arg[:8] == [len(t) for t in table]
    for cls, taps in enumerate(table):
        assert tuple(arg[8 + 8 * cls:8 + 8 * cls + len(taps)]) == taps


@pytest.mark.parametrize("shape,cin,cout", CASES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_implicit_gemm_forward(shape, cin, cout, stride, dtype):
    x, w, b, _ = operands(shape, cin, cout, stride)
    xt, _ = rounded(x, dtype)
    wk, _ = conv3d.kernel_operands(xt, torch.from_numpy(w), None)
    bias = torch.from_numpy(b)
    got = gemm_conv(xt, wk, bias, stride)
    close(got, _k3_math(xt, wk, bias, stride), TOL[dtype])
    close(got, conv3d_k3(xt, torch.from_numpy(w), bias, stride=stride),
          TOL[dtype])
    if dtype == torch.float32:
        ref = np.asarray(lax_conv(jnp.asarray(x), jnp.asarray(w), stride)) + b
        close(got, ref, 1e-5)


def test_implicit_gemm_forward_matches_packed_pallas():
    """The packed Pallas conv (interpret mode) at a channel pair it packs."""
    x, w, _, _ = operands((1, 6, 8, 16), 8, 8, 1)
    xp = pack_channels(jnp.asarray(x), packed_width(16, 8, 8))[0]
    ref = packed_conv3d(xp, jnp.asarray(w), c_in=8, w_valid=16,
                        kernel_size=3, interpret=True)
    ref = np.asarray(unpack_channels(ref[None], 8, 16))
    got = gemm_conv(torch.from_numpy(x), torch.from_numpy(w), None, 1)
    close(got, ref, 1e-5)


@pytest.mark.parametrize("shape,cin,cout", CASES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_input_gradient_layout(shape, cin, cout, stride, dtype):
    """The stride-1 ``dx`` as the forward's GEMM with the adjoint weights;
    the stride-2 ``dx`` by parity class; both against the zero-stuffed
    plain version, the wrapper and, in float32, ``jax.vjp``."""
    x, w, _, g = operands(shape, cin, cout, stride)
    gt, _ = rounded(g, dtype)
    wk, _ = conv3d.kernel_operands(gt, torch.from_numpy(w), None)
    dhw = shape[1:]
    if stride == 1:
        got = gemm_conv(gt, adjoint_k3_weights(wk), None, 1)
    else:
        got = parity_dx(gt, wk, dhw)
    ref = _dx_math(gt, adjoint_k3_weights(wk), dhw, stride)
    close(got, ref, TOL[dtype])
    close(got, conv3d_k3_input_grad(gt, torch.from_numpy(w), dhw, stride),
          TOL[dtype])
    close(got, conv3d_k3_input_grad_plain(gt, torch.from_numpy(w), dhw,
                                          stride), TOL[dtype])
    if dtype == torch.float32:
        _, vjp = jax.vjp(lambda a: lax_conv(a, jnp.asarray(w), stride),
                         jnp.asarray(x))
        close(got, np.asarray(vjp(jnp.asarray(g))[0]), 1e-5)


@pytest.mark.parametrize("shape,cin,cout", CASES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_weight_gradient_gemm(shape, cin, cout, stride, dtype):
    x, w, _, g = operands(shape, cin, cout, stride)
    xt, _ = rounded(x, dtype)
    gt, _ = rounded(g, dtype)
    got = gemm_wgrad(xt, gt, stride)
    close(got, _wgrad_math(xt, gt, stride), 1e-5)
    close(got, conv3d_k3_wgrad(xt, gt, stride), 1e-5)
    if dtype == torch.float32:
        _, vjp = jax.vjp(lambda k: lax_conv(jnp.asarray(x), k, stride),
                         jnp.asarray(w))
        close(got, np.asarray(vjp(jnp.asarray(g))[0]), 1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_autograd_input_gradient_is_the_input_grad_function(stride):
    """``conv3d_k3``'s backward and ``conv3d_k3_input_grad`` are one
    function (the tensor-core path is launched through both)."""
    x, w, _, g = operands((1, 5, 6, 7), 8, 3, stride)
    xt = torch.from_numpy(x).requires_grad_()
    conv3d_k3(xt, torch.from_numpy(w), stride=stride).backward(
        torch.from_numpy(g))
    got = conv3d_k3_input_grad(torch.from_numpy(g), torch.from_numpy(w),
                               x.shape[1:4], stride)
    assert torch.equal(xt.grad, got)


def test_input_grad_rejects_bad_operands():
    g = torch.zeros(1, 3, 3, 3, 4)
    w = torch.zeros(3, 3, 3, 2, 4)
    with pytest.raises(ValueError, match="stride"):
        conv3d_k3_input_grad(g, w, (5, 5, 5), 3)
    with pytest.raises(ValueError, match="ceil"):
        conv3d_k3_input_grad(g, w, (8, 8, 8), 2)
    with pytest.raises(ValueError, match="w must be"):
        conv3d_k3_input_grad(g, torch.zeros(3, 3, 3, 2, 5), (5, 5, 5), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3d_k3_input_grad(g.double(), w, (5, 5, 5), 2)


def test_roofline_tool_before_after_on_cpu(capsys):
    """``tools/bench_packed_conv_torch.py --before-after`` on the CPU: per
    k3 shape (A and D) and per transposed-conv (C) and 1x1x1 (B) shape the
    wrapper and cuDNN's yardstick timed in turns (the CUDA-core column and
    the queued times are empty off the card), with totals."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import bench_packed_conv_torch

    out = bench_packed_conv_torch.main(
        ["--device", "cpu", "--size", "8", "16", "24", "--n-classes", "4",
         "--iters", "1", "--before-after"])
    ba = out["before_after"]
    for name in ("conv3d_k3", "conv3d_k3_wgrad"):
        rows = ba[name]
        assert len(rows) == 13 and sum(r["n"] for r in rows) == 14
        assert all(r["cuda_core_ms"] is None and r["tensor_core_ms"] > 0
                   and r["library_ms"] > 0 and r["bound_ms"] > 0
                   for r in rows)
        assert ba["totals"][name]["cuda_core_ms"] is None
    for name, n_shapes in (("deconv2x", 3), ("conv3d_point", 1)):
        rows = ba[name]
        assert len(rows) == n_shapes and sum(r["n"] for r in rows) == n_shapes
        assert all(r["cuda_core_ms"] is None and r["tensor_core_ms"] > 0
                   and r["library_ms"] > 0 and r["bound_ms"] > 0
                   and r["tensor_core_device_ms"] is None for r in rows)
    # the roofline's 13 k3, 3 transposed-conv and 1 1x1x1 shapes (one
    # warm-up and one call each), then per shape the wrapper twice more for
    # A, D, C and B (in turns, a warm-up and one call each time)
    assert out["calls"] == {"conv3d_k3": 26 + 13 * 4,
                            "conv3d_point": 2 + 4, "deconv2x": 6 + 3 * 4,
                            "conv3d_k3_wgrad": 13 * 4}
    assert "before/after" in capsys.readouterr().out
