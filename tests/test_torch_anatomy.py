"""The matched-label anatomy kernels' plain versions and
``hard_anatomy_dice`` of deepatlas_torch against the JAX package, on the
CPU.

The same numpy labels and grids go through both packages.  The reference is
what ``tests/test_anatomy.py`` holds the TPU kernels to: the dense
composition ``soft_dice_on_probs(grid_sample(one_hot(lab_m)), lab_f)`` on
``clamp_displacement``'d grids, and ``jax.grad`` of it; the matched warp
``m`` is that composition's channel ``lab_f(p)`` at every point.  The value
is also held against the JAX ``hard_anatomy_dice`` (the TPU kernels in
interpret mode) at that file's unmarked size with the identity field.  On
the CPU the port's wrappers run their plain versions through the same
autograd Functions the card uses.

Tolerances: float32, both sides the same 8-corner formula in another order
of additions.  ``m`` lies in [0, 1] (1e-6 absolute); the dice is a ratio of
sums of a few thousand such terms (1e-6); derivative planes and grid
gradients are scaled by ``(n - 1) / 2`` up to 17.5 (1e-5 of their largest
entry).  Random coordinates lie off the integers, where the derivative has
a kink, except where the clamp saturates, whose gradient is zero.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu import ops as jops
from deepatlas_tpu.losses import soft_dice_on_probs as jax_soft_dice
from deepatlas_tpu.pallas.anatomy import binned_sum as jax_binned_sum
from deepatlas_tpu.pallas.anatomy import \
    hard_anatomy_dice as jax_hard_anatomy_dice
from deepatlas_torch import kernels, ops
from deepatlas_torch.kernels import anatomy
from deepatlas_torch.kernels import (binned_sum, hard_anatomy_dice,
                                     matched_grid_grad, matched_warp,
                                     matched_warp_fused)

D, H, W, NC = 24, 20, 36, 6
TZ, R = 4, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def identity(b, dhw=(D, H, W)):
    return np.asarray(jops.identity_grid_batch((b,) + tuple(dhw) + (3,)))


def make_grid(rng, amplitude_vox, b=1, dhw=(D, H, W)):
    """The identity plus a random field of up to ``amplitude_vox`` voxels
    per axis."""
    d, h, w = dhw
    disp = rng.rand(b, d, h, w, 3).astype(np.float32) * 2.0 - 1.0
    scale = np.array([2.0 / (w - 1), 2.0 / (h - 1), 2.0 / (d - 1)],
                     np.float32)
    return (identity(b, dhw) + disp * amplitude_vox * scale).astype(
        np.float32)


def labels(rng, b=1, dhw=(D, H, W)):
    return (rng.randint(0, NC, (b,) + tuple(dhw)).astype(np.int32),
            rng.randint(0, NC, (b,) + tuple(dhw)).astype(np.int32))


def t(a):
    return torch.from_numpy(np.array(a))


def dense_loss(lab_m, lab_f, grid, max_disp):
    """The reference composition: the clamped warp of the one-hot and the
    soft dice on its probabilities."""
    warped = jops.grid_sample(jops.one_hot(lab_m, NC, dtype=jnp.float32),
                              jops.clamp_displacement(grid, max_disp),
                              mode="trilinear")
    return jax_soft_dice(warped, lab_f, NC)


def dense_matched(lab_m, lab_f, grid):
    """m(p): channel lab_f(p) of the trilinear warp of one_hot(lab_m)."""
    warped = jops.grid_sample(jops.one_hot(lab_m, NC, dtype=jnp.float32),
                              grid, mode="trilinear")
    return jnp.take_along_axis(warped, lab_f[..., None], axis=-1)[..., 0]


# case: (batch, amplitude in voxels); "border" samples up to 6 voxels past
# every face, so corners fall outside
CASES = {"smooth": (1, 2.5), "batch2": (2, 2.0), "border": (1, 6.0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matched_kernels_match_the_dense_channel(rng, case):
    """H's ``m``, I's planes and J's grid cotangent against the dense
    composition's channel ``lab_f(p)`` and ``jax.grad`` of it; H, I and J
    agree with each other."""
    b, amp = CASES[case]
    lab_m, lab_f = labels(rng, b)
    grid = make_grid(rng, amp, b)
    ct = rng.randn(b, D, H, W).astype(np.float32)
    jm = dense_matched(jnp.asarray(lab_m), jnp.asarray(lab_f),
                       jnp.asarray(grid))
    jplanes = jax.grad(lambda g: jnp.sum(dense_matched(
        jnp.asarray(lab_m), jnp.asarray(lab_f), g)))(jnp.asarray(grid))
    jdgrid = jax.grad(lambda g: jnp.sum(jnp.asarray(ct) * dense_matched(
        jnp.asarray(lab_m), jnp.asarray(lab_f), g)))(jnp.asarray(grid))

    m = matched_warp(t(lab_m), t(lab_f), t(grid))
    m_fused, planes = matched_warp_fused(t(lab_m), t(lab_f), t(grid))
    dgrid = matched_grid_grad(t(lab_m), t(lab_f), t(grid), t(ct))
    assert m.shape == (b, D, H, W) and planes.shape == (b, D, H, W, 3)
    assert m.dtype == planes.dtype == dgrid.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6)
    assert torch.equal(m, m_fused)
    scale = np.abs(np.asarray(jplanes)).max()
    np.testing.assert_allclose(planes.numpy(), np.asarray(jplanes),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(dgrid.numpy(), np.asarray(jdgrid),
                               atol=1e-5 * scale * np.abs(ct).max())
    np.testing.assert_allclose(dgrid.numpy(), (t(ct)[..., None]
                                               * planes).numpy(),
                               atol=1e-6 * scale * np.abs(ct).max())
    if case == "border":          # some points keep no in-bounds corner
        assert (m == 0).any() and (m > 0).any()


def test_binned_sum_matches_jax_and_bincount(rng):
    """Per-class sums over flattened labels; a label outside [0, n_class)
    counts nowhere, as a zero row of ``one_hot``; the sum is differentiable
    in the values."""
    v = rng.rand(3, 100).astype(np.float32)
    lab = rng.randint(-1, NC + 1, (3, 100)).astype(np.int32)
    want = np.array([v[lab == c].sum() for c in range(NC)])
    got = binned_sum(t(v), t(lab), NC)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_binned_sum(jnp.asarray(v),
                                               jnp.asarray(lab), NC,
                                               chunk=64)), rtol=1e-6)
    vt = t(v).requires_grad_(True)
    (binned_sum(vt, t(lab).long(), NC) * torch.arange(NC)).sum().backward()
    inside = (lab >= 0) & (lab < NC)
    np.testing.assert_array_equal(vt.grad.numpy(),
                                  np.where(inside, lab, 0).astype(np.float32))


@pytest.mark.parametrize("n_class,n,spread", [(2, 1000, 1.0),
                                               (NC, 4097, 1e3),
                                               (33, 20000, 1e-20)])
def test_binned_sum_is_the_same_bits_in_any_order(rng, n_class, n, spread):
    """The fixed-point sums do not depend on the order of the elements:
    under three permutations of values and labels (the order in which the
    card's atomics may land) the sums are equal bit for bit, and equal to
    the float64 sums within one float32 rounding and 2^-e a term (2^-52 of
    n times the largest value), and to the JAX ``binned_sum`` (a chunked
    one-hot matrix product) within 1e-6; values of both signs over a wide
    range of magnitudes."""
    v = ((rng.rand(n) * 2 - 1) * np.exp(rng.randn(n) * 3) * spread).astype(
        np.float32)
    lab = rng.randint(-1, n_class + 1, n).astype(np.int64)
    got = binned_sum(t(v), t(lab), n_class)
    for _ in range(3):
        order = rng.permutation(n)
        again = binned_sum(t(v[order]), t(lab[order]), n_class)
        assert torch.equal(again, got)
    exact = np.array([v[lab == c].astype(np.float64).sum()
                      for c in range(n_class)])
    total = np.abs(v).max() * n
    np.testing.assert_allclose(got.numpy(), exact, rtol=2 ** -23,
                               atol=total * 2.0 ** -51)
    jax_sums = np.asarray(jax_binned_sum(jnp.asarray(v), jnp.asarray(lab),
                                         n_class, chunk=512))
    np.testing.assert_allclose(got.numpy(), jax_sums, rtol=1e-6,
                               atol=1e-6 * np.abs(jax_sums).max())


def test_binned_sum_of_a_nonfinite_value_is_nan(rng):
    """A NaN makes its own class's sum NaN; the other classes keep their
    sums (their scale comes from the finite values), and a non-finite value
    under a label outside [0, n_class) counts nowhere."""
    v = rng.rand(200).astype(np.float32)
    lab = rng.randint(0, NC, 200).astype(np.int64)
    lab[7] = NC
    clean = binned_sum(t(v), t(lab), NC).numpy()
    v[[3, 7]] = [np.nan, np.inf]
    got = binned_sum(t(v), t(lab), NC).numpy()
    assert np.isnan(got[lab[3]])
    keep = np.arange(NC) != lab[3]
    np.testing.assert_array_equal(got[keep], clean[keep])


@pytest.mark.parametrize("fused_grad", [False, True],
                         ids=["matched_grid_grad", "fused"])
@pytest.mark.parametrize("case,b,amp", [("smooth", 1, 2.5),
                                        ("batch2", 2, 2.0),
                                        ("saturated", 1, 8.0)])
def test_hard_anatomy_dice_matches_the_dense_composition(rng, fused_grad,
                                                         case, b, amp):
    """Value and deformation gradient against the dense composition on the
    clamped grid (max_disp 3) and ``jax.grad`` of it; a saturated field
    (up to 8 voxels) gets no gradient past the clamp."""
    lab_m, lab_f = labels(rng, b)
    grid = make_grid(rng, amp, b)
    ref, jgrad = jax.value_and_grad(lambda g: dense_loss(
        jnp.asarray(lab_m), jnp.asarray(lab_f), g, R))(jnp.asarray(grid))
    g = t(grid).requires_grad_(True)
    counts = kernels.launch_counts()
    loss = hard_anatomy_dice(t(lab_m), t(lab_f), g, NC, max_disp=R,
                             fused_grad=fused_grad)
    loss.backward()
    assert kernels.launch_counts() == counts        # the CPU launches none
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(ref)) <= 1e-6
    scale = np.abs(np.asarray(jgrad)).max()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5 * scale)
    if case == "saturated":
        assert (g.grad == 0).any() and (g.grad != 0).any()


def test_hard_anatomy_dice_value_matches_the_tpu_kernel(rng):
    """Against the JAX ``hard_anatomy_dice`` on its Pallas kernels in
    interpret mode, identity field (as ``tests/test_anatomy.py`` runs it
    unmarked), with int64 and uint8 labels that the port converts."""
    lab_m, lab_f = labels(rng)
    grid = identity(1)
    ref = jax_hard_anatomy_dice(jnp.asarray(lab_m), jnp.asarray(lab_f),
                                jnp.asarray(grid), NC, max_disp=R,
                                z_tile=TZ, interpret=True)
    got = hard_anatomy_dice(t(lab_m).long(), t(lab_f).to(torch.uint8),
                            t(grid), NC, max_disp=R)
    assert abs(got.item() - float(ref)) <= 1e-6
    # on the identity the warp is the labels themselves: the plain dice
    dense = dense_loss(jnp.asarray(lab_m), jnp.asarray(lab_f),
                       jnp.asarray(grid), R)
    assert abs(got.item() - float(dense)) <= 1e-6


def test_value_only_use_takes_the_value_kernel(rng):
    """Without a gradient the fused path computes no derivative planes (it
    takes ``matched_warp``), and both settings give one value; with one it
    takes ``matched_warp_fused`` and no ``matched_grid_grad``."""
    lab_m, lab_f = labels(rng)
    grid = t(make_grid(rng, 2.0))
    calls = {}

    def spy(name):
        fn = getattr(anatomy, name)

        def wrapped(*args):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args)
        return mock.patch.object(anatomy, name, wrapped)

    with spy("matched_warp"), spy("matched_warp_fused"), \
            spy("matched_grid_grad"):
        with torch.no_grad():
            a = hard_anatomy_dice(t(lab_m), t(lab_f), grid, NC, max_disp=R,
                                  fused_grad=True)
            b = hard_anatomy_dice(t(lab_m), t(lab_f), grid, NC, max_disp=R)
        assert calls == {"matched_warp": 2}
        g = grid.clone().requires_grad_(True)
        hard_anatomy_dice(t(lab_m), t(lab_f), g, NC, max_disp=R,
                          fused_grad=True).backward()
        assert calls == {"matched_warp": 2, "matched_warp_fused": 1}
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        hard_anatomy_dice(t(lab_m), t(lab_f)[:, :5], grid, NC)


def test_wrappers_refuse_bad_operands(rng):
    lab_m, lab_f = labels(rng)
    grid = t(make_grid(rng, 1.0))
    with pytest.raises(TypeError, match="int32"):
        matched_warp(t(lab_m).long(), t(lab_f), grid)
    with pytest.raises(TypeError, match="float32"):
        matched_warp(t(lab_m), t(lab_f), grid.double())
    with pytest.raises(ValueError, match="contiguous"):
        matched_warp(t(lab_m), t(lab_f),
                     grid.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="expected"):
        matched_warp_fused(t(lab_m), t(lab_f)[:, 1:], grid)
    with pytest.raises(ValueError, match="ct must be"):
        matched_grid_grad(t(lab_m), t(lab_f), grid,
                          torch.zeros(1, D, H, W, dtype=torch.float64))


def test_values_adjoint_of_the_kernel_warp_is_its_splat(rng):
    """The joint seg step's f-hard branch splats the fixed one-hot with
    ``kernels.splat_trilinear`` at the clamped field; that is the values
    adjoint of the clamped kernel warp (autograd through
    ``ops.warp_values_adjoint``) and of the JAX clamped warp; a C = 6
    one-hot."""
    lab_m, _ = labels(rng)
    grid = t(make_grid(rng, 5.0))
    onehot = ops.one_hot(t(lab_m).long(), NC)
    fast = kernels.splat_trilinear(
        onehot, ops.clamp_displacement(grid, R).float().contiguous(),
        onehot.shape[1:4])
    slow = ops.warp_values_adjoint(
        functools.partial(kernels.grid_sample, max_disp=R, grad="values"),
        onehot, grid)
    assert fast.shape == onehot.shape and fast.dtype == torch.float32
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), atol=1e-6)
    ref = jops.warp_values_adjoint(
        lambda v, g: jops.grid_sample(v, jops.clamp_displacement(g, R),
                                      mode="trilinear"),
        jnp.asarray(onehot.numpy()), jnp.asarray(grid.numpy()))
    np.testing.assert_allclose(fast.numpy(), np.asarray(ref), atol=1e-5)
