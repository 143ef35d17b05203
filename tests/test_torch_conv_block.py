"""Kernel K (``conv3d_k3_block``) and the conv tools against the JAX package.

On the CPU ``conv3d_k3_block`` runs its plain version; these tests hold it
against the Pallas kernel it replaces, ``packed_conv3d_block`` in interpret
mode on the packed input (as tests/test_packed_conv.py runs it), at the same
numpy inputs.  float32 within the reference test's 2e-5 absolute (both sides
sum the same float32 products; conftest pins JAX to full precision).  In
bfloat16 both sides round the weights to bf16, accumulate in float32 and
round the sum once, so they agree up to one rounding flip where their
summation orders straddle a bf16 tie: 2^-7 relative (one ulp), 1e-6
absolute for outputs near zero.

The census test holds the port's ``collect_shapes``
(tools/bench_packed_conv_torch.py) against the JAX one
(tools/bench_packed_conv.py) at the recipe's 168x200x168 with 32 classes,
and both tools run once at a tiny size on the CPU.  The kernel itself on the
card is in tests/test_torch_cuda.py.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepatlas_tpu.pallas.conv3d import (pack_channels, packed_conv3d_block,
                                         packed_width, unpack_channels)
from deepatlas_torch.kernels import (conv3d_k3_block, conv3d_k3_block_plain,
                                     conv3d_k3_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-6


def tool(name):
    """A module of tools/ by file name (tools/ is no package)."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def block_jax(x, k, p_blk, h_stored=None):
    """``packed_conv3d_block`` in interpret mode on x packed as the JAX
    model stores it (H padded to ``h_stored`` rows), unpacked to the
    logical ``(1, D, H, W, Cout)``."""
    _, d, h, w, cin = x.shape
    cout = k.shape[-1]
    xp = pack_channels(jnp.asarray(x), packed_width(w, cin, cout),
                       h_stored)[0]
    out = packed_conv3d_block(xp, jnp.asarray(k), c_in=cin, w_valid=w,
                              h_valid=h, p_blk=p_blk, interpret=True)
    return unpack_channels(out[None], cout, w, h)


def inputs(rng, d, h, w, cin, cout):
    x = rng.rand(1, d, h, w, cin).astype(np.float32)
    k = (0.1 * rng.randn(3, 3, 3, cin, cout)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("p_blk,d", [(2, 7), (4, 12), (3, 10)])
def test_block_matches_packed_pallas_f32(rng, p_blk, d):
    """Including depths that are not a multiple of p_blk (the tail)."""
    x, k = inputs(rng, d, 8, 12, 8, 16)
    got = conv3d_k3_block(torch.from_numpy(x), torch.from_numpy(k), p_blk)
    assert got.shape == (1, d, 8, 12, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(block_jax(x, k, p_blk)), atol=2e-5)


@pytest.mark.parametrize("p_blk,d", [(2, 7), (4, 12), (3, 10)])
def test_block_matches_packed_pallas_bf16(rng, p_blk, d):
    x, k = inputs(rng, d, 8, 12, 8, 16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = conv3d_k3_block(xb, torch.from_numpy(k), p_blk)
    ref = block_jax(xb.float().numpy().astype(jnp.bfloat16), k, p_blk)
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_matches_packed_pallas_with_padded_rows(rng, dtype):
    """The JAX model stores H padded to a sublane multiple (100 of 104
    rows at 84x100x84): the kernel reads the pad rows as the conv's zero
    padding and zeroes them in its output; the port takes the logical
    volume."""
    x, k = inputs(rng, 5, 6, 12, 8, 16)
    xt = torch.from_numpy(x).to(dtype)
    got = conv3d_k3_block(xt, torch.from_numpy(k), p_blk=2).float().numpy()
    xj = jnp.asarray(xt.float().numpy())
    if dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    ref = np.asarray(block_jax(xj, k, 2, h_stored=8).astype(jnp.float32))
    assert ref.shape == got.shape == (1, 5, 6, 12, 16)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("cin,cout,p_blk", [(3, 5, 3), (1, 8, 8), (24, 7, 1)])
def test_block_unpackable_channels_match_plain(rng, cin, cout, p_blk):
    """Channel counts the TPU's lane layout refuses (not powers of two, or
    the 1-channel input) -- the port takes them as they are."""
    x, k = inputs(rng, 5, 6, 7, cin, cout)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    got = conv3d_k3_block(xt, kt, p_blk)
    np.testing.assert_allclose(got.numpy(), conv3d_k3_plain(xt, kt).numpy(),
                               atol=1e-6)
    assert torch.equal(conv3d_k3_block_plain(xt, kt, p_blk), got)


def test_block_refuses_a_gradient(rng):
    """Forward only, as ``packed_conv3d_block`` (no VJP)."""
    x, k = inputs(rng, 3, 4, 5, 2, 3)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    for a, b in ((xt.clone().requires_grad_(), kt),
                 (xt, kt.clone().requires_grad_())):
        with pytest.raises(RuntimeError, match="forward only"):
            conv3d_k3_block(a, b)
        with torch.no_grad():
            assert conv3d_k3_block(a, b).shape == (1, 3, 4, 5, 3)


@pytest.mark.parametrize("p_blk", [0, 9, 2.0, True])
def test_block_refuses_other_p_blk(p_blk):
    x, k = torch.zeros(1, 2, 3, 4, 2), torch.zeros(3, 3, 3, 2, 2)
    with pytest.raises(ValueError, match="p_blk"):
        conv3d_k3_block(x, k, p_blk)
    with pytest.raises(ValueError, match="p_blk"):
        conv3d_k3_block_plain(x, k, p_blk)


def jax_census(size, n_classes, in_channel=1):
    """The JAX census in the port's logical terms: ``(kind, (D, H, W,
    Cin), Cout)`` per call, the per-part calls of a conv over a skip
    concatenation (the first conv after each deconv, in two parts:
    upsampled, then skip; models/packed.py:192-207) merged into one, the
    entry conv's zero-padded input channels (models/packed.py:197) back to
    ``in_channel``.  Deconvs keep their stored H (padded), returned apart."""
    calls = tool("bench_packed_conv").collect_shapes(list(size), n_classes)
    out, deconv_rows, pending = [], [], 0
    for i, (kind, xs, ks, kw) in enumerate(calls):
        cin, cout = ks[3], ks[4]
        if kind == "deconv":
            out.append(("deconv2x", (xs[0], None, kw["w_valid_out"] // 2,
                                     cin), cout))
            deconv_rows.append(xs[1])
            pending = 2
            continue
        if i == 0:
            assert cin == 8 and kw["c_in"] == 8     # padded from 1
            cin = in_channel
        shape = (xs[0], kw.get("h_valid") or xs[1], kw["w_valid"])
        name = "conv3d_k3" if ks[0] == 3 else "conv3d_point"
        if pending == 1:
            prev_name, prev_shape, prev_cout = out[-1]
            assert (prev_name, prev_shape[:3], prev_cout) == (name, shape,
                                                              cout)
            out[-1] = (name, shape + (prev_shape[3] + cin,), cout)
        else:
            out.append((name, shape + (cin,), cout))
        pending = max(pending - 1, 0)
    return out, deconv_rows


def test_census_matches_the_jax_census():
    size, n_classes = (168, 200, 168), 32
    port = tool("bench_packed_conv_torch").collect_shapes(size, n_classes)
    assert [c[0] for c in port].count("conv3d_k3") == 14
    assert all(c[1][0] == 1 and c[3] == ({"stride": 1} if c[0] ==
                                         "conv3d_k3" else {}) for c in port)
    # the JAX package runs the deepest level (21x25x21) on XLA
    deepest = tuple(n // 8 for n in size)
    port_cmp = [(kind, xs[1:], ws[-1]) for kind, xs, ws, _ in port
                if not (kind == "conv3d_k3" and xs[1:4] == deepest)]
    ref, deconv_rows = jax_census(size, n_classes)
    assert len(port_cmp) == len(ref) == 16
    rows = iter(deconv_rows)
    for got, want in zip(port_cmp, ref):
        if got[0] == "deconv2x":
            stored = next(rows)
            assert stored >= got[1][1] and stored % 8 == 0
            got = (got[0], (got[1][0], None) + got[1][2:], got[2])
        assert got == want


def test_roofline_tool_runs_on_cpu(capsys):
    out = tool("bench_packed_conv_torch").main(
        ["--device", "cpu", "--size", "8", "16", "24", "--n-classes", "4",
         "--iters", "1", "--step-ms", "100"])
    rows = out["rows"]
    assert out["device"] == "cpu"
    assert sum(r["n"] for r in rows) == 18 and len(rows) == 17
    # one warm-up and --iters calls per unique shape
    assert out["calls"] == {"conv3d_k3": 26, "conv3d_point": 2,
                            "deconv2x": 6}
    assert all(r["bound_ms"] > 0 and np.isfinite(r["ms"]) for r in rows)
    text = capsys.readouterr().out
    assert "not device times" in text and "share of the bf16 peak" in text


def test_block_tool_runs_on_cpu(capsys):
    out = tool("bench_block_conv_torch").main(
        ["--device", "cpu", "--size", "8", "16", "24", "--n-classes", "4",
         "--iters", "1", "--p-blks", "2", "3"])
    rows = out["rows"]
    assert len(rows) == 13 and sum(r["n"] for r in rows) == 14
    # per shape: A once as the reference and timed in turns (twice a warm
    # call and one timed call); K once checked and timed in turns at each
    # p_blk; no CUDA-core K on the CPU
    assert out["calls"] == {"conv3d_k3": 65, "conv3d_k3_block": 130}
    assert all(set(r["k_ms"]) == {2, 3} for r in rows)
    assert all(set(r["k_simt_ms"].values()) == {None} for r in rows)
    assert all(len(r["a_sha256"]) == 64 for r in rows)
    assert all(max(r["max_abs_diff_vs_a"].values()) <= 1e-2 * r["max_abs_a"]
               for r in rows)
    assert set(out["totals"]["k_ms"]) == {2, 3}
    assert "not device times" in capsys.readouterr().out
