"""The channel-parallel warp (E) and the fixed-point splat (G), on the CPU.

The kernels of ``deepatlas_torch/kernels/csrc/warp.cu`` run only on the
card (``tests/test_torch_cuda.py`` holds them there); what they rely on is
arithmetic and index math that the CPU can check, done here in numpy the
way the kernels do it:

* the splat's fixed point: per channel the bits of max |ct|, the exponent
  ``e = min(62 - ceil(log2 P) - ex, 126)`` with ``max < 2^ex``, every term
  ``rint(fl(fl(w_k ct) 2^e))`` as an int64, the int64 sums, each rounded
  once to float32 and scaled by ``2^-e``; a channel whose max is not
  finite is NaN;
* the ways the scatter groups its terms before an atomic: along W (the
  left neighbour's dx = 1 corners, by address: by shuffles in the
  one-point-a-thread kernel, in a carry along a walk in the lanes kernel),
  by channel where a warp's cotangents are sparse -- every grouping gives
  the same int64 sums, bit for bit, in any point order;
* the lane maps: E's 16-byte chunks (``lanes`` lanes a point,
  ``256 // lanes`` points a block) or one thread a point, G's warps of 32
  points walked by the warp, a channel a lane, the max pre-pass's chunks
  and channels, the conversion's 4 elements a thread -- every (point,
  channel) read or written exactly once at C in {1, 2, 3, 5, 8, 16, 32,
  33}, in both types, on a ragged point count;
* G's splat of ones: the known max of 1.0 in place of the max pass gives
  the general path's int64 sums on a tensor of ones, bit for bit;
* F, the grid gradient, in its layouts by row width (one thread a point
  under 16 bytes, a lane a 16-byte chunk with the point's partial sums
  added by xor shuffles in a fixed order, one thread a point at odd
  widths): the derivatives of the corner weights in the kernels' order,
  every lane of a point ending with the same sums, each point read and
  written once at C in {1, 2, 8, 32, 33}, in both types, batch 2 with
  ragged point counts.

The mirror is held against the plain versions (``splat_trilinear_plain``,
``warp_trilinear_plain``, ``warp_grid_grad_plain``) and, in float32,
against the JAX package (the XLA composition's values VJP, the Pallas
splat and the Pallas grid gradient in interpret mode).
The same numpy inputs go to both packages.  Tolerance of the splat against
a float32 sum: 1e-6 of the output's range (the fixed-point sum is exact to
``2^-e`` a term, ``2^-38`` of the channel's max at 5.6 M points; a float32
sum of a few terms is exact to a few float32 roundings).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu import ops as jops
from deepatlas_tpu.ops.warp import warp_values_adjoint
from deepatlas_tpu.pallas import pallas_grid_sample
from deepatlas_torch.kernels import (splat_ones, splat_trilinear,
                                     splat_trilinear_plain, warp_grid_grad,
                                     warp_grid_grad_plain, warp_trilinear,
                                     warp_trilinear_plain)

THREADS = 256           # kThreads in csrc/trilinear.cuh
CHANNELS = (1, 2, 3, 5, 8, 16, 32, 33)
ELEM = {"float32": 4, "bfloat16": 2}
INF_BITS = 0x7F800000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- the mirror

def grid_of(rng, b, dhw, amplitude, out=None):
    """A normalized (x, y, z) grid of the volume's shape (or ``out``):
    identity plus uniform displacements of up to ``amplitude`` voxels, so
    that some samples leave the volume."""
    d, h, w = dhw
    od, oh, ow = dhw if out is None else out
    axes = [np.linspace(-1, 1, n, dtype=np.float32) for n in (od, oh, ow)]
    zz, yy, xx = np.meshgrid(*axes, indexing="ij")
    ident = np.stack([xx, yy, zz], -1)[None].repeat(b, 0)
    scale = np.array([2.0 / (w - 1), 2.0 / (h - 1), 2.0 / (d - 1)],
                     np.float32) * amplitude
    disp = (rng.rand(b, od, oh, ow, 3).astype(np.float32) * 2 - 1) * scale
    return np.ascontiguousarray(ident + disp, dtype=np.float32)


def axis_of(g, n):
    """trilinear.cuh ``axis_of`` in float32: lower index, fraction and
    in-bounds flags of its two corners."""
    v = (g + np.float32(1.0)) * np.float32((n - 1) / 2.0)
    lo = np.floor(v)
    f = v - lo
    in0 = (lo >= 0) & (lo <= n - 1)
    in1 = (lo + 1 >= 0) & (lo + 1 <= n - 1)
    i0 = np.where(in0 | in1, lo, 0).astype(np.int64)
    return i0, f.astype(np.float32), in0, in1


def corners(grid, dhw, c):
    """Per point (flattened over the batch): corner 0's element offset in
    the batch of (D, H, W, C) volumes, the 8 corners' in-bounds mask
    ``(P, 8)`` and float32 weights ``(P, 8)`` (``corners_of``: corner k has
    dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1)."""
    d, h, w = dhw
    b = grid.shape[0]
    g = grid.reshape(b, -1, 3)
    ax, ay, az = (axis_of(g[..., i], n) for i, n in enumerate((w, h, d)))
    base = (np.arange(b)[:, None] * (d * h * w * c))
    off0 = base + ((az[0] * h + ay[0]) * w + ax[0]) * c
    mask, wgt = [], []
    for k in range(8):
        dz, dy, dx = k >> 2, (k >> 1) & 1, k & 1
        wz = az[1] if dz else np.float32(1) - az[1]
        wy = ay[1] if dy else np.float32(1) - ay[1]
        wx = ax[1] if dx else np.float32(1) - ax[1]
        wgt.append((wz * wy * wx).astype(np.float32))
        mask.append((az[3] if dz else az[2]) & (ay[3] if dy else ay[2])
                    & (ax[3] if dx else ax[2]))
    return (off0.reshape(-1), np.stack(mask, -1).reshape(-1, 8),
            np.stack(wgt, -1).reshape(-1, 8))


def deltas(dhw, c):
    d, h, w = dhw
    return np.array([(k >> 2) * h * w * c + ((k >> 1) & 1) * w * c
                     + (k & 1) * c for k in range(8)], np.int64)


def log2_ceil(points):
    lg = 0
    while (1 << lg) < points:
        lg += 1
    return lg


def maxbits(ct):
    """Per channel the bits of max |ct| (float32), as the pre-pass's
    atomicMax on the bit patterns of non-negative floats."""
    flat = np.abs(ct.reshape(-1, ct.shape[-1]).astype(np.float32))
    return flat.view(np.uint32).max(axis=0)


def exponent(bits, lg):
    """``fixed_exponent``: the max is below 2^ex, ex = max(biased
    exponent, 1) - 126; e = min(62 - lg - ex, 126)."""
    ex = np.maximum(bits.astype(np.int64) >> 23, 1) - 126
    return np.minimum(62 - lg - ex, 126)


def terms(ct, grid, dhw):
    """Every term of the splat: ``(address, channel, int64 value)``, the
    address corner k's element offset (channel 0), the value
    ``rint(fl(fl(w_k ct) 2^e))``; 0 for a corner outside the volume or a
    channel whose max is not finite."""
    c = ct.shape[-1]
    points = int(np.prod(grid.shape[1:4]))
    off0, mask, wgt = corners(grid, dhw, c)
    bits = maxbits(ct)
    e = exponent(bits, log2_ceil(points))
    scale = np.ldexp(np.float32(1), e).astype(np.float32)
    cv = ct.reshape(-1, c).astype(np.float32)
    live = bits < INF_BITS
    prod = (wgt[:, :, None] * np.where(live, cv, 0)[:, None, :]).astype(
        np.float32)
    val = np.rint((prod * scale).astype(np.float32)).astype(np.int64)
    val = np.where(mask[:, :, None] & live, val, 0)
    addr = off0[:, None] + deltas(dhw, c)[None, :]
    return addr, val, bits, e


def to_float(acc, bits, e, c):
    """The conversion: each int64 sum rounded once to float32 (torch's cast,
    round to nearest as ``__ll2float_rn``), times 2^-e of its channel; NaN
    where the channel's max is not finite."""
    out = torch.from_numpy(acc).to(torch.float32).numpy().reshape(-1, c)
    out = out * np.ldexp(np.float32(1), -e).astype(np.float32)
    return np.where(bits < INF_BITS, out, np.float32(np.nan))


def splat_direct(ct, grid, dhw, order=None):
    """One atomic a term, in ``order`` of the points: the int64 sums."""
    b, c = ct.shape[0], ct.shape[-1]
    addr, val, bits, e = terms(ct, grid, dhw)
    if order is not None:
        addr, val = addr[order], val[order]
    size = b * int(np.prod(dhw)) * c
    acc = issued_sums(list(zip((addr[..., None] + np.arange(c)).reshape(-1),
                               val.reshape(-1))), size)
    return acc, bits, e


def splat_mirror(ct, grid, dhw):
    b, c = ct.shape[0], ct.shape[-1]
    acc, bits, e = splat_direct(ct, grid, dhw)
    return to_float(acc, bits, e, c).reshape(b, *dhw, c)


def walk_along_w(addr0, val, c, groups):
    """The lanes kernel's dense walk: ``groups`` lists of consecutive
    points (the warps' walks); a point's dx = 1 terms ride in a carry
    to the next point when its corner 0 is the carry's + C, else they are
    flushed.  Returns the atomics issued: ``[(address, value)]``."""
    out = []
    for walk in groups:
        carry, carry_off = None, None
        for j in walk:
            t = val[j].copy()
            if carry is not None and carry_off + c == addr0[j]:
                t[0::2] += carry
            elif carry is not None:
                out += [(carry_off + dk, v) for dk, v in
                        zip(DELTA_ODD, carry)]
            out += [(addr0[j] + dk, v) for dk, v in zip(DELTA_EVEN, t[0::2])]
            carry, carry_off = t[1::2], addr0[j]
        if carry is not None:
            out += [(carry_off + dk, v) for dk, v in zip(DELTA_ODD, carry)]
    return out


def shuffles_along_w(addr0, val, c):
    """The one-point-a-thread scatter: warps of 32 consecutive points (the
    last one ragged); a lane adds its left neighbour's dx = 1 terms where
    its corner 0 is the neighbour's + C, and the neighbour then drops
    them.  Returns the atomics issued."""
    out = []
    p = addr0.shape[0]
    for first in range(0, p, 32):
        pts = np.arange(first, min(first + 32, p))
        off = addr0[pts]
        t = val[pts].copy()
        join = off[:-1] + c == off[1:]          # lane i gives to lane i + 1
        t[1:, 0::2] += np.where(join[:, None], t[:-1, 1::2], 0)
        t[:-1, 1::2] = np.where(join[:, None], 0, t[:-1, 1::2])
        out += [(off[i] + DELTA[k], t[i, k]) for i in range(len(pts))
                for k in range(8)]
    return out


def sparse_pairs(nonzero):
    """The lanes kernel's sparse path for one warp: for each source lane
    (a channel) in turn, lane i takes the i-th of its nonzero points
    (``__fns``).  ``nonzero[src]`` is the bit mask over the walk's steps;
    returns ``[(src, step)]`` in the order taken."""
    taken = []
    for src, bits in enumerate(nonzero):
        steps = [s for s in range(32) if bits >> s & 1]
        for lane in range(32):
            if lane < len(steps):
                taken.append((src, steps[lane]))
    return taken


def issued_sums(issued, size):
    """The int64 sums of ``[(address, value)]``; as the kernels, only
    nonzero values reach memory, and each of those must have an address
    inside the volume (a corner outside it adds 0)."""
    acc = np.zeros(size, np.int64)
    if issued:
        a, v = (np.asarray(x, np.int64) for x in zip(*issued))
        a, v = a[v != 0], v[v != 0]
        assert ((a >= 0) & (a < size)).all()
        np.add.at(acc, a, v)
    return acc


DELTA = DELTA_EVEN = DELTA_ODD = None  # set per volume by ``set_deltas``


def set_deltas(dhw, c):
    global DELTA, DELTA_EVEN, DELTA_ODD
    DELTA = deltas(dhw, c)
    DELTA_EVEN, DELTA_ODD = DELTA[0::2], DELTA[1::2]


# ------------------------------------------------------------ fixed point

@pytest.mark.parametrize("value", [1.0, 3.0, 0.75, 1e-3, 2.0 ** -130, 0.0,
                                   1e30, 3.4e38])
@pytest.mark.parametrize("points", [1, 7, 1 << 20, 168 * 200 * 168])
def test_scale_is_a_power_of_two_with_room(value, points):
    """The per-channel scale 2^e: a power of two, normal in float32 both
    ways, and P max|ct| 2^e <= 2^62 (the worst case: every point adds
    weight 1 to one voxel); at 5.6 M points and max 1, e is 38."""
    bits = np.array([np.float32(value)]).view(np.uint32)
    lg = log2_ceil(points)
    e = int(exponent(bits, lg)[0])
    assert -126 <= e <= 126
    scale = np.ldexp(np.float32(1), e)
    assert np.float32(scale) == scale and np.isfinite(np.float32(scale))
    term = np.rint(np.float64(np.float32(value)) * 2.0 ** e)
    assert term * points <= 2.0 ** 62
    if value > 2.0 ** -100:           # the cap leaves tiny maxima coarser
        assert term * (1 << lg) > 2.0 ** 60   # and otherwise it is tight
    if value == 1.0 and points == 168 * 200 * 168:
        assert e == 38


@pytest.mark.parametrize("c", [1, 3])
def test_all_points_on_one_voxel_do_not_overflow(c):
    """Every point of a 16 x 16 x 16 grid samples voxel (2, 3, 4) with
    weight 1, each with the channel's largest cotangent: the int64 sum is
    P round(max 2^e) <= 2^62 and the output is P max, rounded once.  The
    volume's (n - 1) / 2 are powers of two, so the coordinates are exact."""
    dhw = (5, 9, 17)
    b, pts = 1, (16, 16, 16)
    p = int(np.prod(pts))
    g = np.array([4 / 8 - 1, 3 / 4 - 1, 2 / 2 - 1], np.float32)  # x, y, z
    grid = np.broadcast_to(g, (b, *pts, 3)).astype(np.float32).copy()
    ct = np.full((b, *pts, c), -3.5, np.float32)
    ct[..., 1:] = 2.0 ** 70
    acc, bits, e = splat_direct(ct, grid, dhw)
    assert np.abs(acc).max() <= 2 ** 62
    out = to_float(acc, bits, e, c).reshape(b, *dhw, c)
    np.testing.assert_array_equal(out[0, 2, 3, 4],
                                  np.float32(p) * ct[0, 0, 0, 0])
    assert np.count_nonzero(out) == c


@pytest.mark.parametrize("c", [1, 5, 32])
def test_point_order_does_not_change_a_bit(rng, c):
    """The int64 sums in a shuffled point order equal the sums in point
    order bit for bit (the float32 sums of the plain version need not)."""
    dhw = (6, 9, 11)
    grid = grid_of(rng, 2, dhw, 3.0)
    ct = rng.randn(2, *dhw, c).astype(np.float32)
    ref, bits, e = splat_direct(ct, grid, dhw)
    order = rng.permutation(int(np.prod(grid.shape[:4])))
    got, _, _ = splat_direct(ct, grid, dhw, order)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("c,dtype", [(1, "float32"), (3, "float32"),
                                     (32, "float32"), (2, "bfloat16"),
                                     (32, "bfloat16")])
@pytest.mark.parametrize("amplitude", [1.5, 6.0])
def test_fixed_point_matches_plain(rng, c, dtype, amplitude):
    """The mirror against ``splat_trilinear_plain`` (float32 index_add_)
    and the wrapper on the CPU: within 1e-6 of the range."""
    dhw = (7, 10, 12)
    grid = grid_of(rng, 2, dhw, amplitude)
    ct = torch.from_numpy(rng.randn(2, *dhw, c).astype(np.float32)).to(
        getattr(torch, dtype))
    got = splat_mirror(ct.float().numpy(), grid, dhw)
    ref = splat_trilinear_plain(ct, torch.from_numpy(grid), dhw).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    cpu = splat_trilinear(ct, torch.from_numpy(grid), dhw).numpy()
    np.testing.assert_array_equal(cpu, ref)


@pytest.mark.parametrize("c", [1, 4])
def test_fixed_point_matches_jax(rng, c):
    """The mirror against the JAX package's splat: the values VJP of the
    XLA composition on a clamped field, and the Pallas splat in interpret
    mode (``pallas_grid_sample(grad='values')``'s VJP, as
    ``tests/test_pallas_warp.py`` runs it), in float32."""
    dhw, r = (24, 20, 36), 3
    grid = grid_of(rng, 1, dhw, r - 0.5)
    ct = rng.rand(1, *dhw, c).astype(np.float32)
    got = splat_mirror(ct, grid, dhw)
    xla = np.asarray(warp_values_adjoint(jops.grid_sample, jnp.asarray(ct),
                                         jnp.asarray(grid)))
    assert np.abs(got - xla).max() <= 1e-6 * np.abs(xla).max()
    if c == 1:
        pallas = np.asarray(warp_values_adjoint(
            lambda v, g: pallas_grid_sample(v, g, max_disp=r, z_tile=4,
                                            grad="values", interpret=True),
            jnp.asarray(ct), jnp.asarray(grid)))
        assert np.abs(got - pallas).max() <= 1e-5 * np.abs(pallas).max()


def test_zero_cotangents_change_no_bit(rng):
    """A one-hot cotangent: the terms of its zeros are 0, so skipping them
    (the sparse path, one atomic a nonzero (point, channel) and corner)
    gives the same int64 sums as adding them all (the dense walk)."""
    dhw, c = (5, 6, 40), 32
    grid = grid_of(rng, 1, dhw, 2.0)
    labels = rng.randint(0, c, (1, *dhw))
    ct = np.eye(c, dtype=np.float32)[labels]
    addr, val, bits, e = terms(ct, grid, dhw)
    set_deltas(dhw, c)
    size = int(np.prod(dhw)) * c
    p = addr.shape[0]
    dense = issued_sums([(addr[j, 0] + ch + DELTA[k], val[j, k, ch])
                         for j in range(p) for ch in range(c)
                         for k in range(8)], size)
    sparse = issued_sums([(addr[j, 0] + ch + DELTA[k], val[j, k, ch])
                          for j, ch in zip(*np.nonzero(ct.reshape(p, c)))
                          for k in range(8)], size)
    np.testing.assert_array_equal(sparse, dense)
    ref, _, _ = splat_direct(ct, grid, dhw)
    np.testing.assert_array_equal(dense, ref)


@pytest.mark.parametrize("c", [1, 32])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_nonfinite_channel_is_nan(rng, c, bad):
    """A NaN or an infinity in a channel's cotangent makes that channel NaN
    everywhere; the plain version is not finite at least where it lands;
    the other channels keep their values."""
    dhw = (5, 6, 7)
    grid = grid_of(rng, 1, dhw, 1.0)
    ct = rng.randn(1, *dhw, c).astype(np.float32)
    clean = splat_mirror(ct, grid, dhw)
    ct[0, 2, 3, 3, 0] = bad
    got = splat_mirror(ct, grid, dhw)
    assert np.isnan(got[..., 0]).all()
    np.testing.assert_array_equal(got[..., 1:], clean[..., 1:])
    ref = splat_trilinear_plain(torch.from_numpy(ct), torch.from_numpy(grid),
                                dhw).numpy()
    assert (~np.isfinite(ref[..., 0])).any()


# ---------------------------------------------------- groupings of terms

@pytest.mark.parametrize("c", [4, 16, 32, 33])
@pytest.mark.parametrize("field", ["smooth", "saturated"])
def test_walk_along_w_gives_the_same_sums(rng, c, field):
    """The lanes kernel's dense walk: warps of 32 consecutive points, each
    lane walking the warp's points in its channel of a group of 32, a
    point's dx = 1 terms carried to the next point by address -- across
    row, depth and batch breaks, the volume's borders and a ragged last
    warp -- gives the direct sums bit for bit."""
    dhw, b = (4, 5, 37), 2
    grid = grid_of(rng, b, dhw, 1.0 if field == "smooth" else 9.0)
    if field == "saturated":       # clamped: many points share an offset
        grid = np.clip(grid, -0.9, 0.9)
    ct = rng.randn(b, *dhw, c).astype(np.float32)
    addr, val, _, _ = terms(ct, grid, dhw)
    set_deltas(dhw, c)
    p = addr.shape[0]
    size = b * int(np.prod(dhw)) * c
    acc = np.zeros(size, np.int64)
    walks = [list(range(first, min(first + 32, p)))
             for first in range(0, p, 32)]
    for ch in range(c):
        issued = walk_along_w(addr[:, 0], val[:, :, ch], c, walks)
        acc += issued_sums([(a + ch, v) for a, v in issued], size)
    ref, _, _ = splat_direct(ct, grid, dhw)
    np.testing.assert_array_equal(acc, ref)


@pytest.mark.parametrize("out", [None, (3, 11, 40)])
@pytest.mark.parametrize("amplitude", [0.0, 2.0, 7.0])
@pytest.mark.parametrize("c", [1, 3])
def test_shuffles_along_w_give_the_same_sums(rng, out, amplitude, c):
    """The one-point-a-thread kernel (rows under 16 bytes): terms grouped
    along W by shuffles give the direct sums bit for bit -- batch 2, a grid
    of another shape, row breaks inside a warp, a ragged last warp -- on a
    field shifted by 0.3 voxels and on noise of 2 and 7 voxels; the shift
    (neighbours keep their offsets, as on a smooth field) takes about four
    atomics a point and channel instead of eight."""
    dhw, b = (5, 13, 45), 2
    grid = grid_of(rng, b, dhw, amplitude, out)
    if amplitude == 0.0:
        grid = grid + np.float32(0.3) * np.array(
            [2.0 / (n - 1) for n in dhw[::-1]], np.float32)
    ct = rng.randn(*grid.shape[:4], c).astype(np.float32)
    addr, val, _, _ = terms(ct, grid, dhw)
    set_deltas(dhw, c)
    size = b * int(np.prod(dhw)) * c
    acc = np.zeros(size, np.int64)
    atomics = 0
    for ch in range(c):
        issued = shuffles_along_w(addr[:, 0], val[..., ch], c)
        acc += issued_sums([(a + ch, v) for a, v in issued], size)
        atomics += sum(v != 0 for _, v in issued)
    ref, _, _ = splat_direct(ct, grid, dhw)
    np.testing.assert_array_equal(acc, ref)
    if amplitude == 0.0 and out is None:
        assert atomics < 4.5 * c * addr.shape[0]


def test_sparse_pairs_take_each_nonzero_once(rng):
    """The sparse path's enumeration: every set bit of every source lane's
    mask taken exactly once, at most 32 a round."""
    for density in (0.02, 0.2, 1.0):
        nonzero = [int(sum(1 << s for s in range(32) if rng.rand() < density))
                   for _ in range(32)]
        taken = sparse_pairs(nonzero)
        want = [(src, s) for src, bits in enumerate(nonzero)
                for s in range(32) if bits >> s & 1]
        assert sorted(taken) == want


# ------------------------------------------------------------- lane maps

def e_cover(p, c, elem):
    """E's threads: where a row is ``lanes`` 16-byte chunks, ``lanes`` a
    power of two up to 32, a lane a chunk and ``256 // lanes`` points a
    block (whole warps: a lane past the last point loads and stores
    nothing); else one thread a point, all its channels.  Returns how
    often each (point, channel) is read and written."""
    seen = np.zeros((p, c), np.int64)
    v = 16 // elem
    lanes = c // v
    if c % v or not 0 < lanes <= 32 or lanes & (lanes - 1):
        seen[:] = 1
        return seen
    per_block = THREADS // lanes
    for blk in range(-(-p // per_block)):
        for tid in range(THREADS):
            pt = blk * per_block + tid // lanes
            if pt < p:
                c0 = (tid & (lanes - 1)) * v
                seen[pt, c0:c0 + v] += 1
    return seen


def g_cover(p, c, elem):
    """G's lanes kernel (rows of 16 bytes and more): warps of 32 points,
    lane l walking them in channel l of each group of 32 channels; under
    16 bytes one thread a point, all its channels."""
    seen = np.zeros((p, c), np.int64)
    if c * elem < 16:
        seen[:] = 1
        return seen
    for first in range(0, p, 32):
        for lane in range(32):
            for c0 in range(0, c, 32):
                ch = c0 + lane
                for pj in range(first, first + 32):
                    if ch < c and pj < p:
                        seen[pj, ch] += 1
    return seen


def absmax_cover(n, c, elem):
    """The max pre-pass: ``blocks`` (a multiple of C / gcd(C, 256 V), at
    most 528) x 256 threads, thread t reading chunks t, t + T, ...: every
    element once, slot j of a thread always channel (t V + j) % C."""
    v = 16 // elem
    unit = c // np.gcd(c, THREADS * v)
    blocks = min(-(-n // (THREADS * v)), 528)
    blocks = -(-blocks // unit) * unit
    stride = blocks * THREADS
    seen = np.zeros(n, np.int64)
    for t in range(stride):
        for i in range(t, -(-n // v), stride):
            idx = np.arange(i * v, min(i * v + v, n))
            seen[idx] += 1
            assert ((idx % c) == (t * v + idx - i * v) % c).all()
    return seen


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("dtype", sorted(ELEM))
def test_lane_maps_cover_each_value_once(c, dtype):
    """At a ragged point count (1000: no multiple of a block's points or of
    32): E and G touch every (point, channel) exactly once, the max
    pre-pass reads every cotangent once in its channel and the
    conversion's 4-element threads cover the volume once."""
    p, elem = 1000, ELEM[dtype]
    assert (e_cover(p, c, elem) == 1).all()
    assert (g_cover(p, c, elem) == 1).all()
    assert (absmax_cover(p * c, c, elem) == 1).all()
    n = p * c
    conv = np.zeros(n, np.int64)
    for t in range(-(-n // 4)):
        conv[t * 4:min(t * 4 + 4, n)] += 1
    assert (conv == 1).all()


# ------------------------------------------------------- E, the same sums

@pytest.mark.parametrize("c", [8, 32, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_reusing_left_corners_matches_plain(rng, c, dtype):
    """E's rows kernel takes a point's dx = 0 corners from its left
    neighbour where their addresses agree and both corners are inside; the
    blend over the corners in order, emulated here with that reuse, equals
    ``warp_trilinear_plain`` within one rounding of the type (float32: the
    same sums in another order; bfloat16: 1e-2 of the range)."""
    dhw = (6, 7, 19)
    grid = grid_of(rng, 2, dhw, 3.0)
    vol = torch.from_numpy(rng.rand(2, *dhw, c).astype(np.float32)).to(dtype)
    off0, mask, wgt = corners(grid, dhw, c)
    set_deltas(dhw, c)
    flat = vol.float().numpy().reshape(-1)
    rows = np.zeros((off0.shape[0], 8, c), np.float32)
    for k in range(8):
        for j in range(off0.shape[0]):
            if mask[j, k]:
                rows[j, k] = flat[off0[j] + DELTA[k]:off0[j] + DELTA[k] + c]
    reused = rows.copy()
    prev = np.full_like(off0, -(1 << 62))
    prev[1:] = off0[:-1]
    take = prev + c == off0
    for k in range(0, 8, 2):
        ok = take & mask[:, k] & np.roll(mask[:, k + 1], 1)
        reused[ok, k] = np.roll(rows[:, k + 1], 1, axis=0)[ok]
    np.testing.assert_array_equal(reused, rows)
    acc = np.zeros((off0.shape[0], c), np.float32)
    for k in range(8):
        acc += np.where(mask[:, k, None], wgt[:, k, None] * reused[:, k], 0)
    got = torch.from_numpy(acc.reshape(2, *dhw, c)).to(dtype).float()
    ref = warp_trilinear_plain(vol, torch.from_numpy(grid)).float()
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert (got - ref).abs().max() <= tol * ref.abs().max()
    np.testing.assert_array_equal(
        warp_trilinear(vol, torch.from_numpy(grid)).float().numpy(),
        ref.numpy())


# --------------------------------------------------------------- the tool

def test_bench_tool_runs_on_the_cpu():
    """``tools/bench_warp_torch.py --device cpu`` at a tiny size: every
    kernel of every case on one field, the seg step per label regime, the
    JSON line's rows, no device numbers."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_warp_torch.py")
    spec = importlib.util.spec_from_file_location("bench_warp_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tool.main(["--device", "cpu", "--size", "16", "16", "16",
                     "--iters", "1", "--fields", "smooth", "--seg-step"])
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert {(r["case"], r["kernel"]) for r in out["rows"]} == {
        (case, k) for case, *_ in tool.CASES for k in tool.KERNELS} | {
        ("c1_float32", "splat_ones")}
    for r in out["rows"]:
        assert r["device_ms"] is None and r["held_mb"] is None
        assert r["finite"] and r["bit_identical_rerun"]
        assert r["bound_ms"] > 0
    assert set(out["seg_step"]) == {"soft", "f_hard", "m_hard", "hard"}
    assert all(v["device_busy_ms"] is None for v in out["seg_step"].values())


# ------------------------------------------------- G, the splat of ones

def test_splat_of_ones_is_the_general_path_bit_for_bit(rng):
    """The splat of ones skips the max pass and reads no cotangent: the
    kernel takes the bits of 1.0 as the channel's max and 1.0 as every
    cotangent.  Its terms and int64 sums are those of the general path on
    a tensor of ones, bit for bit (the max pass over ones gives the same
    bits), at batch 2 on a smooth and a saturated field; the wrapper on the
    CPU is the plain splat of a tensor of ones."""
    dhw, b = (6, 9, 35), 2
    for amplitude in (1.0, 9.0):
        grid = grid_of(rng, b, dhw, amplitude)
        ones = np.ones((b, *dhw, 1), np.float32)
        general, bits, e = splat_direct(ones, grid, dhw)
        assert bits[0] == np.float32(1.0).view(np.uint32)
        off0, mask, wgt = corners(grid, dhw, 1)
        known = np.array([0x3F800000], np.uint32)
        ek = exponent(known, log2_ceil(int(np.prod(dhw))))
        scale = np.ldexp(np.float32(1), ek).astype(np.float32)
        val = np.rint((wgt * np.float32(1.0) * scale).astype(
            np.float32)).astype(np.int64)
        val = np.where(mask, val, 0)
        addr = off0[:, None] + deltas(dhw, 1)[None, :]
        acc = issued_sums(list(zip(addr.reshape(-1), val.reshape(-1))),
                          b * int(np.prod(dhw)))
        np.testing.assert_array_equal(acc, general)
        np.testing.assert_array_equal(ek, e)
        np.testing.assert_array_equal(
            to_float(acc, known, ek, 1).reshape(b, *dhw, 1),
            splat_mirror(ones, grid, dhw))
        got = splat_ones(torch.from_numpy(grid), dhw)
        ref = splat_trilinear_plain(torch.from_numpy(ones),
                                    torch.from_numpy(grid), dhw)
        assert torch.equal(got, ref)


# ----------------------------------------------- F, the grid gradient

def gg_layout(c, elem):
    """``grid_grad``'s choice: rows under 16 bytes one thread a point
    (``points``), whole 16-byte chunks a lane (``rows``, lanes a power of
    two up to 32), else one thread a point (``thread``)."""
    v = 16 // elem
    lanes = c // v
    if c * elem < 16:
        return "points", 1
    if c % v == 0 and lanes <= 32 and lanes & (lanes - 1) == 0:
        return "rows", lanes
    return "thread", 1


def corner_values(vol, grid):
    """Per point (flattened over the batch) the 8 corners' values ``(P, 8,
    C)`` (0 outside the volume) and the fractions ``(fz, fy, fx)``."""
    b, d, h, w, c = vol.shape
    g = grid.reshape(b, -1, 3)
    fr = [axis_of(g[..., i], n)[1].reshape(-1)
          for i, n in enumerate((w, h, d))]
    off0, mask, _ = corners(grid, (d, h, w), c)
    flat = vol.reshape(-1)
    addr = off0[:, None] + deltas((d, h, w), c)[None, :]
    idx = np.where(mask, addr, 0)[..., None] + np.arange(c)
    vals = np.where(mask[..., None], flat[idx], np.float32(0))
    return vals.astype(np.float32), (fr[2], fr[1], fr[0])


def derivatives(v, fz, fy, fx):
    """``corner_derivatives`` in float32 on ``(P, 8, ...)`` corner values:
    the terms added in the kernel's order."""
    one = np.float32(1)
    wz, wy, wx = (one - fz, fz), (one - fy, fy), (one - fx, fx)
    shape = (-1,) + (1,) * (v.ndim - 2)
    dx = dy = dz = np.zeros(v[:, 0].shape, np.float32)
    for i in range(2):
        for j in range(2):
            dx = dx + (wz[i] * wy[j]).reshape(shape) * (
                v[:, 4 * i + 2 * j + 1] - v[:, 4 * i + 2 * j])
            dy = dy + (wz[i] * wx[j]).reshape(shape) * (
                v[:, 4 * i + 2 + j] - v[:, 4 * i + j])
            dz = dz + (wy[i] * wx[j]).reshape(shape) * (
                v[:, 4 + 2 * i + j] - v[:, 2 * i + j])
    return dx, dy, dz


def butterfly(parts):
    """The lanes' partial sums ``(P, lanes)`` added by xor shuffles at
    distances lanes / 2, ..., 1: what every lane holds at the end
    ``(P, lanes)``."""
    lanes = parts.shape[1]
    o = lanes // 2
    while o >= 1:
        parts = (parts + parts[:, np.arange(lanes) ^ o]).astype(np.float32)
        o //= 2
    return parts


def grid_grad_mirror(vol, grid, ct, elem):
    """F as the kernels compute it, by ``gg_layout``: per point the sum
    over channels of ct * the derivatives, in channel order, or per lane
    over its 16-byte chunk and then across the point's lanes by the xor
    butterfly; scaled by (n - 1) / 2 per axis.  Returns ``(B, Do, Ho, Wo,
    3)`` and, for the rows layout, every lane's sums (all equal)."""
    b, d, h, w, c = vol.shape
    vals, (fz, fy, fx) = corner_values(vol, grid)
    cv = ct.reshape(-1, c).astype(np.float32)
    dx, dy, dz = derivatives(vals, fz, fy, fx)          # (P, C) each
    layout, lanes = gg_layout(c, elem)
    sums, all_lanes = [], None
    for dv in (dx, dy, dz):
        if layout == "rows":
            v = c // lanes
            parts = np.zeros((cv.shape[0], lanes), np.float32)
            for ch in range(c):
                parts[:, ch // v] = (parts[:, ch // v]
                                     + cv[:, ch] * dv[:, ch]).astype(
                                         np.float32)
            lanes_sum = butterfly(parts)
            all_lanes = lanes_sum if all_lanes is None else all_lanes
            sums.append(lanes_sum[:, 0])
        else:
            acc = np.zeros(cv.shape[0], np.float32)
            for ch in range(c):
                acc = (acc + cv[:, ch] * dv[:, ch]).astype(np.float32)
            sums.append(acc)
    scale = [np.float32((n - 1) / 2.0) for n in (w, h, d)]
    out = np.stack([s * k for s, k in zip(sums, scale)], -1)
    return out.reshape(*grid.shape[:4], 3).astype(np.float32), all_lanes


@pytest.mark.parametrize("c", [1, 2, 8, 32, 33])
@pytest.mark.parametrize("dtype", sorted(ELEM))
@pytest.mark.parametrize("field", ["smooth", "saturated"])
def test_grid_grad_layouts_match_plain(rng, c, dtype, field):
    """F's mirror in each layout (C = 1, 2: one thread a point; 8 and 32:
    a lane a 16-byte chunk, except 8 bf16 rows of one chunk and 2 float32
    chunks; 33: one thread a point) against ``warp_grid_grad_plain`` within
    1e-5 of its largest entry (float32 sums in another order), batch 2, a
    smooth field and a saturated one whose points share corners; the
    values are those of the type; the wrapper on the CPU is the plain
    version; in the rows layout every lane of a point ends with the same
    sums (the xor butterfly)."""
    dhw, b = (5, 7, 19), 2
    grid = grid_of(rng, b, dhw, 1.0 if field == "smooth" else 9.0)
    if field == "saturated":
        grid = np.clip(grid, -0.9, 0.9)
    tdt = getattr(torch, dtype)
    vol = torch.from_numpy(rng.rand(b, *dhw, c).astype(np.float32)).to(tdt)
    ct = torch.from_numpy((rng.rand(b, *dhw, c) * 2 - 1).astype(
        np.float32)).to(tdt)
    got, lanes_sums = grid_grad_mirror(vol.float().numpy(), grid,
                                       ct.float().numpy(), ELEM[dtype])
    ref = warp_grid_grad_plain(vol, torch.from_numpy(grid), ct).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if lanes_sums is not None:
        assert (lanes_sums == lanes_sums[:, :1]).all()
    np.testing.assert_array_equal(
        warp_grid_grad(vol, torch.from_numpy(grid), ct).numpy(), ref)


@pytest.mark.parametrize("c", [1, 2, 8, 32, 33])
@pytest.mark.parametrize("dtype", sorted(ELEM))
def test_grid_grad_lane_maps_cover_each_point_once(c, dtype):
    """At a ragged point count per sample (1000 and 2500: no multiple of a
    block) and batch 2 (blockIdx.y the sample): the points kernel (256
    points a block, one a thread) and the rows kernel (256 / lanes points a
    block, a lane a chunk, the point's first lane writing; whole warps run
    to their end for the shuffles) read every (point, channel) once and
    write every point's gradient once."""
    elem = ELEM[dtype]
    layout, lanes = gg_layout(c, elem)
    for points in (1000, 2500):
        read = np.zeros((2, points, c), np.int64)
        wrote = np.zeros((2, points), np.int64)
        for s in range(2):
            if layout == "points":
                for blk in range(-(-points // THREADS)):
                    for t in range(THREADS):
                        i = blk * THREADS + t
                        if i < points:
                            read[s, i] += 1
                            wrote[s, i] += 1
            elif layout == "rows":
                v = 16 // elem
                per_block = THREADS // lanes
                for blk in range(-(-points // per_block)):
                    for t in range(THREADS):
                        i = blk * per_block + t // lanes
                        first = i - (t & 31) // lanes  # the warp's first
                        if first >= points:
                            continue                   # the warp returns
                        c0 = (t & (lanes - 1)) * v
                        if i < points:
                            read[s, i, c0:c0 + v] += 1
                            wrote[s, i] += c0 == 0
            else:
                read[s] += 1
                wrote[s] += 1
        assert (read == 1).all() and (wrote == 1).all()


@pytest.mark.parametrize("c", [1, 8])
def test_grid_grad_mirror_matches_pallas(rng, c):
    """In float32 against the JAX package's grid gradient, the VJP of
    ``pallas_grid_sample`` in interpret mode (``_bwd_grid_kernel``), on a
    field inside its bound (max_disp 3): one thread a point at C = 1, two
    16-byte chunks a point at C = 8; within 1e-4 of the largest entry (the
    Pallas kernel's tent form rounds differently: tests/test_torch_warp.py
    holds the same tolerance)."""
    dhw, r = (8, 8, 20), 3
    grid = grid_of(rng, 1, dhw, r - 1.0)
    vol = rng.rand(1, *dhw, c).astype(np.float32)
    ct = rng.randn(1, *dhw, c).astype(np.float32)
    got, _ = grid_grad_mirror(vol, grid, ct, 4)
    _, vjp = jax.vjp(lambda g: pallas_grid_sample(
        jnp.asarray(vol), g, max_disp=r, z_tile=4, interpret=True),
        jnp.asarray(grid))
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
