"""Kernel K on the tensor cores (``conv3d_k3_block_mma`` in
``deepatlas_torch/kernels/csrc/conv3d_mma.cu``): its tile, halo, slot and
tap order, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` holds it
there); what it relies on is index math that the CPU can check, done here in
torch the way the kernel does it: kernel A's implicit GEMM with a tile
``p_blk`` planes deep --

* a block owns a 16 x 4 x p_blk (x, y, z) tile of output voxels and up to
  64 output channels (``NT`` n-tiles of 8: 1, 2, 4 or 8 by the padded Cout,
  further blocks for wider outputs); its ``2 p_blk`` warps own two 16-voxel
  x-lines each (line ``2 warp + mt`` is plane ``line // 4``, row
  ``line % 4``);
* K is walked 8 input channels a stage (channels padded by zeros to a
  multiple of 8 in shared memory only); a stage holds the (p_blk + 2) x 6 x
  18 halo, one 16-byte slot a voxel, starting one voxel before the tile
  (the conv's padding), and the (28 x 8) x N weights of
  ``pack_k3_weights`` (27 taps and a zero tap);
* a k-chunk is taps ``2c`` and ``2c + 1``: each lane's A row is the slot of
  its voxel shifted by the tap's ``(kz * 6 + ky) * 18 + kx``; tap 27 reads
  the zero slot;
* the epilogue stores only voxels inside the volume: a depth that is no
  multiple of p_blk leaves the tail tile's last planes unstored (they read
  the zero padding).

The emulation is held against ``conv3d_k3_block_plain`` and the wrapper on
the CPU at p_blk 1..8, ragged depths, heights and widths and Cin, Cout in
{1, 3, 8, 16, 64}, every output voxel written exactly once, and in float32
against the JAX package's ``packed_conv3d_block`` in interpret mode.  Inputs
hold bfloat16 values, as the kernel reads them, so that float32 sums of
their products differ only in order: 1e-5 of the output's largest entry;
the bfloat16 output within one rounding (1e-2).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from deepatlas_tpu.pallas.conv3d import (pack_channels, packed_conv3d_block,
                                         packed_width, unpack_channels)
from deepatlas_torch.kernels import (conv3d_k3_block, conv3d_k3_block_plain,
                                     pack_k3_weights)

TX, TY, MT = 16, 4, 2           # CV_TX, CV_TY, CV_MT in csrc/conv3d_mma.cu
NTAP = 28                       # 27 taps and a zero tap a stage
SMEM_LIMIT = 232448             # shared memory a block can use on an H100
CHANNELS = [(1, 3), (3, 8), (8, 16), (16, 64), (64, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def round8(n):
    return -(-n // 8) * 8


def n_tiles(np_):
    """``dispatch_conv``: n-tiles of 8 a block for NP padded channels."""
    return 1 if np_ <= 8 else 2 if np_ <= 16 else 4 if np_ <= 32 else 8


def geometry(p_blk, nt):
    """Threads, halo (HZ, HY, HX), slots and shared-memory bytes of the
    kernel's instance ``<kFwdS1, NT, TZ = p_blk>`` (``cv_threads``,
    ``ConvGeo``, ``cv_smem_bytes``)."""
    hz, hy, hx = p_blk + 2, TY + 2, TX + 2
    wld = 8 if nt == 1 else 8 * nt + 8
    stage = hz * hy * hx * 16 + NTAP * 8 * wld * 2
    return {"threads": 32 * TY * p_blk // MT, "halo": (hz, hy, hx),
            "slots": hz * hy * hx, "smem": 2 * stage + 16 + 16 * 4}


def tap_offset(t):
    """``fwd_tap_offset<kFwdS1>``: tap ``kz*9 + ky*3 + kx``'s slot shift."""
    kz, ky, kx = t // 9, (t // 3) % 3, t % 3
    return (kz * (TY + 2) + ky) * (TX + 2) + kx


def line_rows(p_blk):
    """Each lane row's slot offset from the halo's origin, ``(lines, 16)``,
    in the order the warps own the lines (``2 warp + mt``), and the lines'
    (z, y) within the tile."""
    hy, hx = TY + 2, TX + 2
    lines = [2 * warp + mt for warp in range(2 * p_blk) for mt in range(MT)]
    zy = [(line // TY, line % TY) for line in lines]
    rows = torch.tensor([[(lz * hy + ly) * hx + lx for lx in range(TX)]
                         for lz, ly in zy])
    return rows, zy


def emulate(x, wk, p_blk):
    """The block conv as the tensor-core kernel computes it, block by
    block: float32 sums of the staged bf16 products, rounded once to x's
    type.  Returns the output and how often each output voxel was
    stored."""
    b, d, h, w, cin = x.shape
    cout = wk.shape[-1]
    cp, np_ = round8(cin), round8(cout)
    nt = n_tiles(np_)
    bn = 8 * nt
    packed = pack_k3_weights(wk).float()          # (K_pad, NP)
    hz, hy, hx = geometry(p_blk, nt)["halo"]
    tiles = (-(-d // p_blk), -(-h // TY), -(-w // TX))
    # the input with its zero padding: one voxel before, past the last tile
    xp = F.pad(x.float(), (0, cp - cin,
                           1, tiles[2] * TX + 1 - w,
                           1, tiles[1] * TY + 1 - h,
                           1, tiles[0] * p_blk + 1 - d))
    rows, zy = line_rows(p_blk)
    zero = hz * hy * hx                           # the zero slot's index
    y = torch.zeros(b, d, h, w, cout)
    stored = torch.zeros(b, d, h, w, dtype=torch.int64)
    for bi in range(b):
        for tz in range(tiles[0]):
            for ty in range(tiles[1]):
                for tx in range(tiles[2]):
                    z0, y0, x0 = tz * p_blk, ty * TY, tx * TX
                    for n0 in range(0, np_, bn):
                        acc = torch.zeros(rows.numel(), bn)
                        for s in range(cp // 8):
                            halo = xp[bi, z0:z0 + hz, y0:y0 + hy, x0:x0 + hx,
                                      8 * s:8 * s + 8].reshape(-1, 8)
                            halo = torch.cat([halo, torch.zeros(1, 8)])
                            wst = torch.zeros(NTAP * 8, bn)
                            for tap in range(27):
                                src = packed[tap * cp + 8 * s:
                                             tap * cp + 8 * s + 8,
                                             n0:min(n0 + bn, np_)]
                                wst[tap * 8:tap * 8 + 8, :src.shape[1]] = src
                            for c in range(NTAP // 2):
                                a = [halo[rows.reshape(-1) + tap_offset(t)]
                                     if t < 27 else halo[torch.full(
                                         (rows.numel(),), zero)]
                                     for t in (2 * c, 2 * c + 1)]
                                acc += torch.cat(a, dim=1) @ wst[16 * c:
                                                                 16 * c + 16]
                        acc = acc.reshape(len(zy), TX, bn)
                        for i, (lz, ly) in enumerate(zy):
                            oz, oy = z0 + lz, y0 + ly
                            for lx in range(TX):
                                ox = x0 + lx
                                if oz >= d or oy >= h or ox >= w:
                                    continue
                                cols = min(cout - n0, bn)
                                if cols <= 0:
                                    continue
                                y[bi, oz, oy, ox, n0:n0 + cols] = \
                                    acc[i, lx, :cols]
                                if n0 == 0:
                                    stored[bi, oz, oy, ox] += 1
    return y.to(x.dtype), stored


def operands(rng, shape, cin, cout):
    """x and w holding bfloat16 values (what the kernel reads)."""
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout)
                          / np.sqrt(27 * cin)).astype(np.float32))
    return x.bfloat16().float(), w.bfloat16().float()


def close(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("p_blk", range(1, 9))
@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_tile_emulation_matches_plain(rng, p_blk, cin, cout):
    """At every p_blk and the channel counts of the issue's list, on a
    batch of 2 with a depth of 7 (a multiple of p_blk only at 1 and 7), a
    height of 6 (a ragged second row of tiles) and a width of 21 (a ragged
    second 16-wide tile): the emulated kernel equals the plain version
    within float32 summation order, every output voxel is stored exactly
    once, and the wrapper on the CPU is the plain version."""
    x, w = operands(rng, (2, 7, 6, 21), cin, cout)
    got, stored = emulate(x, w, p_blk)
    ref = conv3d_k3_block_plain(x, w, p_blk=p_blk)
    close(got, ref, 1e-5)
    assert (stored == 1).all()
    assert torch.equal(conv3d_k3_block(x, w, p_blk=p_blk), ref)


@pytest.mark.parametrize("p_blk", [1, 3, 4, 8])
@pytest.mark.parametrize("cin,cout", [(3, 8), (16, 64), (64, 16)])
def test_tile_emulation_in_bfloat16(rng, p_blk, cin, cout):
    """bfloat16 in and out: the same sums rounded once, against the plain
    version within one rounding; Cout 64 at Cin 64 is the widest block
    (NT = 8), Cout above 64 takes a second block of channels."""
    x, w = operands(rng, (1, 5, 9, 17), cin, cout)
    got, _ = emulate(x.bfloat16(), w, p_blk)
    close(got, conv3d_k3_block_plain(x.bfloat16(), w, p_blk=p_blk), 1e-2)


def test_wide_output_takes_a_second_block_of_channels(rng):
    """Cout 72: NP = 72, two blocks of 64 channels, the second one holding
    one n-tile of weights and seven of zeros; every channel written."""
    x, w = operands(rng, (1, 3, 5, 18), 8, 72)
    got, stored = emulate(x, w, 4)
    close(got, conv3d_k3_block_plain(x, w, p_blk=4), 1e-5)
    assert (stored == 1).all()


@pytest.mark.parametrize("p_blk,d", [(2, 7), (3, 10), (5, 12), (8, 12)])
def test_tile_emulation_matches_packed_pallas(rng, p_blk, d):
    """In float32 against the JAX package's ``packed_conv3d_block`` in
    interpret mode (as tests/test_torch_conv_block.py runs it), on the
    channel counts its lane layout packs; depths no multiple of p_blk."""
    x, w = operands(rng, (1, d, 8, 12), 8, 16)
    got, _ = emulate(x, w, p_blk)
    xp = pack_channels(jnp.asarray(x.numpy()), packed_width(12, 8, 16))[0]
    out = packed_conv3d_block(xp, jnp.asarray(w.numpy()), c_in=8, w_valid=12,
                              h_valid=8, p_blk=p_blk, interpret=True)
    ref = np.asarray(unpack_channels(out[None], 16, 12, 8))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("p_blk", range(1, 9))
def test_lines_warps_and_shared_memory(p_blk):
    """The 2 p_blk warps own the tile's 4 p_blk x-lines once each, two
    apiece; the threads are 64 p_blk (A's 128 at p_blk 2); every instance's
    two stages fit the shared memory a block can use, and its halo rows of
    every tap stay inside the staged slots."""
    rows, zy = line_rows(p_blk)
    assert sorted(zy) == [(z, yy) for z in range(p_blk) for yy in range(TY)]
    for nt in (1, 2, 4, 8):
        geo = geometry(p_blk, nt)
        assert geo["threads"] == 64 * p_blk <= 1024
        assert geo["smem"] <= SMEM_LIMIT
        assert rows.max().item() + tap_offset(26) < geo["slots"]
    if p_blk == 2:
        assert geometry(2, 8)["threads"] == 128
