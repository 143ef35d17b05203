"""LNCC on brains over a zero background, where its window sums must keep
their digits.

A skull-stripped brain lies on exact zeros, and a near-identity trilinear
warp leaks a thousandth of its edge into that background.  Windows there
hold tiny values, so their variances and cross terms are differences of
sums near 0; LNCC divides by ``i_var * j_var + 1e-6``, so a window sum off
by the rounding of anything larger than the window's own total throws the
gradient far off.  A float32 prefix sum along a whole axis is such a sum:
its totals reach ~1e4 here.  The port's float32 ``lncc_loss`` is held to
the same function in float64, and to a direct ``avg_pool3d`` window sum,
on the single-process path and on the depth-sharded ``axis_name`` path (a
one-shard axis in this process, two gloo ranks in two more).

Tolerances: the value within 1e-6 of float64's (0.667; float32 rounding of
the windows' own sums reads 4e-8 here, the direct sum 1.6e-7) and the
gradient within 4e-4 of float64's in norm (6e-7 and 1.3e-5 read; float32
prefix sums over whole axes read 1.6e-5 and 4.4e-2, the gradient a hundred
times the bound).  On the CPU torch accumulates a float32 prefix sum in
float64 and rounds each entry once, so a stretch of zeros keeps one prefix
value and its windows read exactly 0; a CUDA scan adds in float32 along a
tree, so such a stretch need not, and on an H100 whole-axis float32 prefix
sums put the joint reg step's first gradient 1e8 times off a direct sum's.
"""
import multiprocessing as mp
import os
import traceback

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepatlas_torch.losses import lncc_loss
from deepatlas_torch.parallel.mesh import Axis

N, BORDER, K = 64, 16, 9
VALUE_TOL, GRAD_TOL = 1e-6, 4e-4


def brain_pair():
    """``(1, N, N, N, 1)`` float32 moving and fixed brains: 4^3 blocks of
    intensity 0.5-1 with noise 0.05, a 16-voxel zero border, each edge
    leaking 1e-3 (moving) and 2e-3 (fixed) of itself outwards per axis."""
    g = torch.Generator().manual_seed(0)
    m = N - 2 * BORDER
    inner = slice(BORDER, N - BORDER)
    blocks = torch.rand(1, 4, 4, 4, 1, generator=g, dtype=torch.float64)
    up = blocks
    for ax in (1, 2, 3):
        up = up.repeat_interleave(m // 4, ax)
    out = []
    for leak in (1e-3, 2e-3):
        x = torch.zeros(1, N, N, N, 1, dtype=torch.float64)
        x[:, inner, inner, inner] = 0.5 + 0.5 * up + 0.05 * torch.randn(
            1, m, m, m, 1, generator=g, dtype=torch.float64)
        for ax in (1, 2, 3):
            x = (1 - leak) * x + leak * torch.roll(x, 1, ax)
        out.append(x.float())
    return out


def pooled_lncc(i, j, window=K, eps=1e-6):
    """The loss with each window summed directly (``avg_pool3d``)."""
    i, j = (t.permute(0, 4, 1, 2, 3) for t in (i, j))
    n = float(window ** 3)

    def wsum(x):
        return F.avg_pool3d(x, window, stride=1) * n

    i_sum, j_sum = wsum(i), wsum(j)
    i2, j2, ij = wsum(i * i), wsum(j * j), wsum(i * j)
    i_mean, j_mean = i_sum / n, j_sum / n
    cross = ij - i_mean * j_sum - j_mean * i_sum + i_mean * j_mean * n
    i_var = i2 - 2 * i_mean * i_sum + i_mean ** 2 * n
    j_var = j2 - 2 * j_mean * j_sum + j_mean ** 2 * n
    return 1.0 - torch.mean(cross ** 2 / (i_var * j_var + eps))


def value_and_grad(fn, moving, fixed, dtype):
    x = moving.to(dtype).detach().requires_grad_(True)
    loss = fn(x, fixed.to(dtype))
    loss.backward()
    return float(loss.detach()), x.grad.double()


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def pair():
    return brain_pair()


@pytest.fixture(scope="module")
def exact(pair):
    return value_and_grad(lncc_loss, *pair, torch.float64)


@pytest.mark.parametrize("axis", [None, Axis("space")],
                         ids=["single_process", "one_shard_halo"])
def test_float32_lncc_holds_its_digits_on_a_zero_background(pair, exact,
                                                             axis):
    ours = value_and_grad(lambda a, b: lncc_loss(a, b, K, axis_name=axis),
                          *pair, torch.float32)
    pooled = value_and_grad(pooled_lncc, *pair, torch.float32)
    assert abs(ours[0] - exact[0]) <= VALUE_TOL
    assert rel(ours[1], exact[1]) <= GRAD_TOL
    # the direct sum stands within the same bounds: both are float32
    # rounding of each window's own total
    assert abs(ours[0] - pooled[0]) <= VALUE_TOL
    assert rel(ours[1], pooled[1]) <= GRAD_TOL


def _rank(rank, init, pair, q):
    try:
        torch.set_num_threads(1)
        from deepatlas_torch.parallel import make_mesh, shard_volume_batch
        mesh = make_mesh(space=2, init_method=init, rank=rank, world_size=2)
        moving, fixed = (torch.from_numpy(shard_volume_batch(t.numpy(), mesh))
                         for t in pair)
        x = moving.detach().requires_grad_(True)
        loss = lncc_loss(x, fixed, K, axis_name=mesh.axis("space"))
        loss.backward()
        # each rank's seed of 1 hands it 2 times its share (psum's
        # backward sums over the axis; the spatial steps divide by 2)
        q.put((rank, float(loss.detach()), x.grad.numpy() / 2))
    except Exception:
        q.put((rank, None, traceback.format_exc()))


def test_two_shard_halo_lncc_holds_its_digits(pair, exact, tmp_path):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = "file://" + os.path.join(str(tmp_path), "pg")
    procs = [ctx.Process(target=_rank, args=(r, init, pair, q), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    for rank, value, grad in got:
        assert value is not None, f"rank {rank}:\n{grad}"
        assert abs(value - exact[0]) <= VALUE_TOL
    grad = torch.from_numpy(np.concatenate([g for _, _, g in got], axis=1))
    assert rel(grad.double(), exact[1]) <= GRAD_TOL
