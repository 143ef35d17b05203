"""The layout and index math of the tensor-core channel mix, on the CPU.

The bfloat16 kernel of ``deepatlas_torch/kernels/csrc/channel_mix_mma.cu``
(the transposed conv ``deconv2x`` with 8 taps, the 1x1x1 conv
``conv3d_point`` with 1) runs only on the card (``tests/test_torch_cuda.py``
holds it there); what it relies on is arithmetic that the CPU can check,
done here in torch the way the kernel does it:

* ``pack_mix_weights``' ``(K_pad, TAPS * NP)`` matrix: row ``ci``, column
  ``t * NP + co``, K padded to 16 and each tap's channels to 8;
* the GEMM over tiles of 128 consecutive flattened input voxels, the last
  one ragged (zero rows), each block owning up to 64 output channels of
  every tap (wider Cout split over blocks);
* the epilogue: each pass of taps ((a, p) and q = 0, 1 for the transposed
  conv) rounded once to the output's type and written, one 16-byte chunk of
  8 channels (one channel where Cout is not a multiple of 8) per step of
  the copy loop, to its output voxel: ``base(v) + tap(t)`` with the base at
  ``(b, 2d, 2h, 2w)`` of the doubled grid -- across the row, depth and batch
  breaks that fall inside a tile, every output value written exactly once;
  the 1x1x1 conv with Cout not a multiple of 8 writes its tile as one
  contiguous run from a 16-byte aligned start, in 16-byte pieces;
* the shared-memory swizzle: a permutation of each row's 16-byte chunks
  under which the 8 rows of an ``ldmatrix`` (or of an accumulator store)
  fall on distinct banks.

Each is held against the plain versions (``_deconv_math``,
``_point_math``) and the wrappers, and in float32 against the JAX package:
``lax`` / flax at every channel pair, and its packed Pallas kernels in
interpret mode at channel pairs they take (powers of two, a width that is a
multiple of their w-group).  The same numpy inputs go to both packages.
Tolerances, relative to the output's largest entry: float32 1e-5 (the same
float32 products summed in another order); bfloat16 1e-2 (one rounding of
the output, which a different summation order can move by one bf16 step).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from deepatlas_tpu.pallas.conv3d import (pack_channels, packed_conv3d,
                                         packed_width, unpack_channels)
from deepatlas_tpu.pallas.deconv3d import packed_deconv2x
from deepatlas_torch.kernels import conv3d_point, deconv2x, pack_mix_weights
from deepatlas_torch.kernels.conv3d import _point_math, kernel_operands
from deepatlas_torch.kernels.deconv3d import _deconv_math

TILE = 128  # input voxels of a tile (MX_VOX in csrc/channel_mix_mma.cu)
TAPS = {"deconv2x": 8, "conv3d_point": 1}
CINS = (1, 3, 8, 16, 32, 48, 64)
COUTS = (1, 5, 8, 16, 32, 64)
# 210 voxels: a full tile and a ragged one of 82; W odd; a tile holds
# breaks of rows (7 voxels), depths (35) and the batch (105)
SHAPE = (2, 3, 5, 7)
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def operands(kind, shape, cin, cout, seed=230):
    """numpy x, w ``(*taps, Cin, Cout)`` and bias; w holds bfloat16 values,
    as the packed weights do, so that float32 checks of the layout are
    exact."""
    rng = np.random.RandomState(seed)
    lead = (2, 2, 2) if kind == "deconv2x" else ()
    x = rng.randn(*shape, cin).astype(np.float32)
    w = torch.from_numpy((rng.randn(*lead, cin, cout) / np.sqrt(cin)).astype(
        np.float32)).bfloat16().float().numpy()
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def close(got, ref, tol):
    got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


# ------------------------------------------------- the kernel's index math

def swz(r, c, p):
    """Chunk slot of 16-byte chunk ``c`` of row ``r`` in a tile of ``p``
    chunks per row (``swz`` in csrc/channel_mix_mma.cu)."""
    s = 0
    if p & (p - 1) == 0:
        s = r & 7 if p >= 8 else ((r * p) >> 3) & (p - 1)
    return r * p + (c ^ s)


def block_channels(cout):
    """Output channels of a block: ``8 * NT`` for the smallest NT in 1, 2,
    4, 8 that covers Cout, at most 64 (``mix_nt``; its shared-memory cap
    binds only at Cin above 500, no case here)."""
    n8 = -(-cout // 8)
    return 8 * next(nt for nt in (1, 2, 4, 8) if nt >= n8 or nt == 8)


def out_base(v, taps, dhw):
    """Output voxel of tap 0 of the flattened input voxels ``v``: ``v``
    itself for the 1x1x1 conv, ``(b, 2d, 2h, 2w)`` of the doubled grid for
    the transposed conv."""
    if taps == 1:
        return v
    d, h, w = dhw
    iw, v = v % w, v // w
    ih, v = v % h, v // h
    iz, ib = v % d, v // d
    return ((ib * 2 * d + 2 * iz) * 2 * h + 2 * ih) * 2 * w + 2 * iw


def tap_offset(t, taps, dhw):
    """How far tap ``t = (a, p, q)`` lands from tap 0: a planes, p rows and
    q voxels of the doubled grid."""
    if taps == 1:
        return 0
    _, h, w = dhw
    a, p, q = t >> 2, (t >> 1) & 1, t & 1
    return (a * 2 * h + p) * 2 * w + q


def mix_tiles(x, wk, bk, taps):
    """``y[out(v, t)] = x[v] @ w[t] + bias`` as the kernel computes it:
    the packed weights, 128-voxel tiles of K-padded rows, per block of
    channels and pass of taps a float32 GEMM plus the float32 bias rounded
    once to x's type, then the copy loop's chunks to their output
    addresses (each must be written exactly once)."""
    b, d, h, w, cin = x.shape
    cout = wk.shape[-1]
    packed = pack_mix_weights(wk).float()
    kp, npad = packed.shape[0], packed.shape[1] // taps
    cb, tp = block_channels(cout), 2 if taps == 8 else 1
    nvox = b * d * h * w
    xf = F.pad(x.reshape(nvox, cin).float(), (0, kp - cin))
    bias = torch.zeros(npad + cb)
    if bk is not None:
        bias[:cout] = bk
    y = torch.zeros(nvox * taps * cout, dtype=x.dtype)
    written = torch.zeros(nvox * taps * cout, dtype=torch.int32)
    unit = 8 if cout % 8 == 0 else 1  # 16-byte chunks or single values
    run = taps == 1 and unit == 1 and cb >= cout  # the tile as one run
    for co0 in range(0, npad, cb):
        n_co = min(cb, cout - co0)
        for v0 in range(0, nvox, TILE):
            nv = min(TILE, nvox - v0)
            a = F.pad(xf[v0:v0 + nv], (0, 0, 0, TILE - nv))
            base = out_base(torch.arange(v0, v0 + nv), taps, (d, h, w))
            for p in range(taps // tp):
                stage = torch.zeros(TILE, tp, cb)
                for t in range(tp):
                    col0 = (p * tp + t) * npad + co0
                    cols = torch.zeros(kp, cb)
                    m = min(cb, npad - co0)
                    cols[:, :m] = packed[:, col0:col0 + m]
                    stage[:, t] = (a @ cols + bias[co0:co0 + cb]).to(
                        x.dtype).float()
                if run:
                    # staged compactly (voxel v's value c at v Cout + c) and
                    # copied as 16-byte pieces of the run, then a tail
                    assert (v0 * cout) % 8 == 0
                    n_el = nv * cout
                    flat = stage[:nv, 0, :cout].reshape(-1)
                    for first, last, step in ((0, n_el // 8 * 8, 8),
                                              (n_el // 8 * 8, n_el, 1)):
                        for e in range(step):
                            src = torch.arange(first + e, last, step)
                            y[v0 * cout + src] = flat[src].to(x.dtype)
                            written.index_add_(0, v0 * cout + src, torch.ones(
                                len(src), dtype=torch.int32))
                    continue
                per_tap = n_co // unit
                i = torch.arange(nv * tp * per_tap)
                v, r = i // (tp * per_tap), i % (tp * per_tap)
                t, c = r // per_tap, r % per_tap
                offs = torch.tensor([tap_offset(p * tp + s, taps, (d, h, w))
                                     for s in range(tp)])
                dst = (base[v] + offs[t]) * cout + co0 + unit * c
                for e in range(unit):
                    y[dst + e] = stage[v, t, unit * c + e].to(x.dtype)
                    written.index_add_(0, dst + e, torch.ones(
                        len(dst), dtype=torch.int32))
    assert torch.all(written == 1)
    up = 2 if taps == 8 else 1
    return y.reshape(b, up * d, up * h, up * w, cout)


# ------------------------------------------------------------ references

def lax_point(x, w, b):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w)[None, None, None], (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))) + b


def flax_deconv(x, w, b):
    """flax's ConvTranspose(k2, s2) with the (2, 2, 2, O, I) kernel, as the
    JAX package's standard tree holds it."""
    layer = nn.ConvTranspose(w.shape[-1], (2, 2, 2), strides=(2, 2, 2),
                             padding="VALID", use_bias=False,
                             transpose_kernel=True)
    return np.asarray(layer.apply(
        {"params": {"kernel": jnp.asarray(w.transpose(0, 1, 2, 4, 3))}},
        jnp.asarray(x))) + b


def plain_and_wrapper(kind, xt, w, bias):
    """The plain math on the wrapper's rounded operands, and the wrapper
    (which takes the plain version for a CPU tensor)."""
    wk, bk = kernel_operands(xt, w, bias)
    if kind == "deconv2x":
        return _deconv_math(xt, wk, bk), deconv2x(xt, w, bias)
    return _point_math(xt, wk, bk), conv3d_point(xt, w, bias)


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("taps", [1, 8])
@pytest.mark.parametrize("cin,cout", [(1, 1), (3, 5), (8, 8), (16, 32),
                                      (48, 64), (64, 5)])
def test_pack_mix_weights_layout(taps, cin, cout):
    rng = np.random.RandomState(0)
    lead = (2, 2, 2) if taps == 8 else ()
    w = torch.from_numpy(rng.randn(*lead, cin, cout).astype(
        np.float32)).to(torch.bfloat16).float()
    packed = pack_mix_weights(w)
    kp, npad = -(-cin // 16) * 16, -(-cout // 8) * 8
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (kp, taps * npad)
    body = packed.float().reshape(kp, taps, npad)
    assert torch.equal(body[:cin, :, :cout],
                       w.reshape(taps, cin, cout).transpose(0, 1))
    assert not body[cin:].any() and not body[:, :, cout:].any()


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 6])
def test_swizzle_is_a_conflict_free_row_permutation(p):
    """Each row's chunks are permuted within the row; for a power of two,
    8 rows from a multiple of 8 at one chunk column (an ldmatrix matrix, an
    accumulator store) cover the 8 16-byte bank groups of 128 bytes; other
    widths are stored unswizzled."""
    for r in range(64):
        assert sorted(swz(r, c, p) for c in range(p)) == \
            list(range(r * p, (r + 1) * p))
    if p & (p - 1):
        assert all(swz(r, c, p) == r * p + c for r in range(16)
                   for c in range(p))
        return
    for r0 in range(0, 64, 8):
        for c in range(p):
            groups = {swz(r0 + i, c, p) % 8 for i in range(8)}
            assert len(groups) == 8, groups


@pytest.mark.parametrize("kind", sorted(TAPS))
@pytest.mark.parametrize("cin", CINS)
@pytest.mark.parametrize("cout", COUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_gemm_and_epilogue(kind, cin, cout, dtype):
    """The tiles, passes and copy loop against the plain version and the
    wrapper and, in float32, against lax (the 1x1x1 conv) or flax's
    ConvTranspose (the transposed conv) on the same numpy inputs."""
    x, w, b = operands(kind, SHAPE, cin, cout)
    xt = torch.from_numpy(x).to(dtype)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    wk, bk = kernel_operands(xt, wt, bt)
    got = mix_tiles(xt, wk, bk, TAPS[kind])
    assert got.dtype == dtype
    plain, wrapped = plain_and_wrapper(kind, xt, wt, bt)
    close(got, plain, TOL[dtype])
    close(got, wrapped, TOL[dtype])
    if dtype == torch.float32:
        ref = flax_deconv(x, w, b) if kind == "deconv2x" \
            else lax_point(x, w, b)
        close(got, ref, 1e-5)


@pytest.mark.parametrize("kind", sorted(TAPS))
@pytest.mark.parametrize("cin,cout", [(16, 72), (8, 136)])
def test_wide_cout_splits_over_channel_blocks(kind, cin, cout):
    """Cout above 64: blocks of 64 channels (and a last one of 8), each
    reading the whole input tile."""
    x, w, b = operands(kind, (1, 3, 4, 11), cin, cout)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wk, bk = kernel_operands(xt, torch.from_numpy(w), torch.from_numpy(b))
    math = _deconv_math if kind == "deconv2x" else _point_math
    close(mix_tiles(xt, wk, bk, TAPS[kind]), math(xt, wk, bk), 1e-2)


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 32), (32, 32), (64, 64)])
def test_deconv_tiles_match_packed_pallas(cin, cout):
    """The packed Pallas transposed conv (interpret mode), batch by batch,
    at a width that is a multiple of its w-group."""
    x, w, _ = operands("deconv2x", (2, 3, 5, 16), cin, cout)
    got = mix_tiles(torch.from_numpy(x), torch.from_numpy(w), None, 8)
    xp = pack_channels(jnp.asarray(x), 16)
    ref = np.stack([np.asarray(unpack_channels(packed_deconv2x(
        xp[i], jnp.asarray(w), c_in=cin, w_valid_out=32,
        interpret=True)[None], cout, 32))[0] for i in range(2)])
    close(got, ref, 1e-5)


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 16), (16, 8), (64, 64)])
def test_point_tiles_match_packed_pallas(cin, cout):
    """The packed Pallas 1x1x1 conv (interpret mode), batch by batch."""
    x, w, _ = operands("conv3d_point", (2, 3, 5, 16), cin, cout)
    got = mix_tiles(torch.from_numpy(x), torch.from_numpy(w), None, 1)
    xp = pack_channels(jnp.asarray(x), packed_width(16, cin, cout))
    ref = np.stack([np.asarray(unpack_channels(packed_conv3d(
        xp[i], jnp.asarray(w)[None, None, None], c_in=cin, w_valid=16,
        kernel_size=1, interpret=True)[None], cout, 16))[0]
        for i in range(2)])
    close(got, ref, 1e-5)
