"""The warp ops and kernels' plain versions of deepatlas_torch against the
JAX package, on the CPU.

The same numpy arrays go through both packages.  The forward is held against
``pallas_grid_sample(..., interpret=True)`` (the TPU kernel in interpret
mode, at the size the JAX package's own unmarked tests use) and against the
XLA composition ``ops.warp.grid_sample`` on ``clamp_displacement``'d grids;
the two gradients against ``jax.grad`` of that composition, which is what
the JAX package holds its Pallas kernels to (their interpret-mode gradients
take minutes).  On the CPU the port's wrappers run their plain versions
through the same autograd Function the card uses.

Tolerances: float32 on [0, 1] data, both sides the same 8-corner formula in
another order of additions: 1e-5 absolute against the XLA composition,
1e-4 against the Pallas kernel (its tent-weight form rounds differently;
the JAX package's own tolerance).  Grid gradients are scaled by
``(n - 1) / 2`` up to 17.5, so they get 1e-4.  Test coordinates are random
and so off the integers, where the derivative has a kink.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu import ops as jops
from deepatlas_tpu.pallas import pallas_grid_sample
from deepatlas_torch import kernels, ops
from deepatlas_torch.kernels import (grid_sample, splat_trilinear,
                                     warp_grid_grad, warp_trilinear)

D, H, W = 24, 20, 36
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


def make_field(rng, amplitude_vox, b=1, dhw=(D, H, W)):
    """Random displacement field bounded by ``amplitude_vox`` voxels."""
    d, h, w = dhw
    disp = rng.rand(b, d, h, w, 3).astype(np.float32) * 2.0 - 1.0
    scale = np.array([amplitude_vox * 2.0 / (w - 1),
                      amplitude_vox * 2.0 / (h - 1),
                      amplitude_vox * 2.0 / (d - 1)], np.float32)
    return disp * scale


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- grids

def test_identity_grids_and_normalize_displacement(rng):
    for shape in ((5, 7, 9), (1, 4, 6)):
        ref = np.asarray(jops.identity_grid(shape))
        got = ops.identity_grid(shape).numpy()
        np.testing.assert_array_equal(got, ref)
        raw = ops.identity_grid(shape, normalize=False).numpy()
        np.testing.assert_array_equal(
            raw, np.asarray(jops.identity_grid(shape, normalize=False)))
    got = ops.identity_grid_batch((3, 5, 7, 9, 1))
    assert got.shape == (3, 5, 7, 9, 3)
    np.testing.assert_array_equal(got.numpy(), identity(3, (5, 7, 9)))
    disp = rng.randn(2, 5, 7, 9, 3).astype(np.float32)
    np.testing.assert_allclose(
        ops.normalize_displacement(t(disp)).numpy(),
        np.asarray(jops.normalize_displacement(jnp.asarray(disp))),
        rtol=1e-6)


@pytest.mark.parametrize("in_shape,out_shape", [
    ((11, 13, 11), (21, 25, 21)), ((6, 5, 4), (12, 10, 8)),
    ((9, 8, 7), (4, 8, 5))])
def test_nearest_and_trilinear_resize(rng, in_shape, out_shape):
    vol = rng.rand(2, *in_shape, 3).astype(np.float32)
    ref = np.asarray(jops.nearest_resize(jnp.asarray(vol), out_shape))
    got = ops.nearest_resize(t(vol), out_shape)
    np.testing.assert_array_equal(got.numpy(), ref)
    # torch's own nearest rule, the one the reference network uses
    lib = torch.nn.functional.interpolate(
        t(vol).permute(0, 4, 1, 2, 3), size=out_shape).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), lib.numpy())
    for align in (False, True):
        ref = np.asarray(jops.trilinear_resize(jnp.asarray(vol), out_shape,
                                               align_corners=align))
        got = ops.trilinear_resize(t(vol), out_shape, align_corners=align)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # the gradient of the nearest resize sums over the copies
    x = t(vol).requires_grad_(True)
    ct = rng.rand(2, *out_shape, 3).astype(np.float32)
    (ops.nearest_resize(x, out_shape) * t(ct)).sum().backward()
    gref = jax.grad(lambda v: jnp.sum(
        jops.nearest_resize(v, out_shape) * ct))(jnp.asarray(vol))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gref), atol=1e-6)


# -------------------------------------------------------------- forward

CASES = {
    # name: (batch, channels, amplitude in voxels, max_disp)
    "smooth": (1, 1, 2.5, R),
    "saturated": (1, 2, 4.0 * R, R),
    "batch_channels": (2, 2, 1.5, R),
    "unclamped": (1, 1, 6.0, None),
}


def case_inputs(rng, name):
    b, c, amp, max_disp = CASES[name]
    vol = rng.rand(b, D, H, W, c).astype(np.float32)
    grid = make_field(rng, amp, b) + identity(b)
    return vol, grid.astype(np.float32), max_disp


def xla_reference(vol, grid, max_disp):
    g = jnp.asarray(grid)
    if max_disp is not None:
        g = jops.clamp_displacement(g, max_disp)
    return jops.grid_sample(jnp.asarray(vol), g, mode="trilinear")


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_xla_composition(rng, name):
    vol, grid, max_disp = case_inputs(rng, name)
    got = grid_sample(t(vol), t(grid), max_disp=max_disp)
    ref = np.asarray(xla_reference(vol, grid, max_disp))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    if name == "saturated":
        vox = np.abs(grid - identity(1)) * (np.array([W, H, D]) - 1) / 2.0
        assert (vox > R).mean() > 0.4           # the clamp really acts
        unclamped = grid_sample(t(vol), t(grid), max_disp=None).numpy()
        assert np.abs(unclamped - ref).max() > 0.1
    if max_disp is None:                        # ops.grid_sample, the same
        again = ops.grid_sample(t(vol), t(grid), mode="trilinear")
        np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("name", ["smooth", "saturated", "batch_channels"])
def test_forward_matches_pallas_kernel_in_interpret_mode(rng, name):
    vol, grid, max_disp = case_inputs(rng, name)
    ref = pallas_grid_sample(jnp.asarray(vol), jnp.asarray(grid),
                             max_disp=max_disp, z_tile=TZ, interpret=True)
    got = grid_sample(t(vol), t(grid), max_disp=max_disp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_zero_padding_past_the_border(rng):
    vol = rng.rand(1, D, H, W, 1).astype(np.float32)
    grid = (identity(1) + 0.08).astype(np.float32)       # pushed past +1
    ref = np.asarray(xla_reference(vol, grid, R))
    got = grid_sample(t(vol), t(grid), max_disp=R).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # 0.08 is 1.4 voxels along x: the last x plane samples past the volume
    assert (got[0, :, :, -1] == 0).all() and (got[0, :, :, -3] != 0).any()
    far = np.full((1, 3, 3, 3, 3), 7.0, np.float32)      # no corner inside
    assert warp_trilinear(t(vol), t(far)).abs().max().item() == 0.0


def test_bfloat16_values_round_once(rng):
    vol, grid, _ = case_inputs(rng, "batch_channels")
    vb = t(vol).bfloat16()
    got = grid_sample(vb, t(grid), max_disp=R)
    assert got.dtype == torch.bfloat16
    # float32 sums of the bf16 values, rounded once: within half a bf16 ulp
    # (2^-9 relative) of the float32 result on the same rounded values
    ref = np.asarray(xla_reference(vb.float().numpy(), grid, R))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-6,
                               rtol=2.0 ** -8)


def test_output_grid_of_another_shape(rng):
    """Without the clamp the grid may have any spatial shape."""
    vol = rng.rand(2, 7, 6, 5, 2).astype(np.float32)
    grid = (rng.rand(2, 3, 4, 9, 3) * 2.4 - 1.2).astype(np.float32)
    ref = jops.grid_sample(jnp.asarray(vol), jnp.asarray(grid))
    got = grid_sample(t(vol), t(grid), max_disp=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(ValueError, match="volume's shape"):
        grid_sample(t(vol), t(grid), max_disp=3)


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_grad_of_the_xla_composition(rng, name):
    """``dgrid`` (kernel F's plain version) and ``dvol`` (kernel G's) through
    the autograd Function, the clamp's mask included."""
    vol, grid, max_disp = case_inputs(rng, name)
    ct = rng.rand(*vol.shape).astype(np.float32)

    def loss(v, g):
        return jnp.sum(xla_reference(v, g, max_disp) * ct)

    gv_ref, gg_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vol),
                                                    jnp.asarray(grid))
    v = t(vol).requires_grad_(True)
    g = t(grid).requires_grad_(True)
    (grid_sample(v, g, max_disp=max_disp) * t(ct)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(gv_ref), atol=1e-5)
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(gg_ref), atol=1e-4,
                               rtol=1e-4)
    if name == "saturated":
        # past the bound the field gets no gradient
        disp = np.abs(grid - identity(1)) * (np.array([W, H, D]) - 1) / 2.0
        assert (g.grad.numpy()[disp > R + 1e-3] == 0).all()
        # (inside it, points sampled past the border get none either)
        assert (g.grad.numpy()[disp < R - 1e-3] != 0).mean() > 0.7


def test_wrappers_match_jax_vjp_directly(rng):
    """``warp_grid_grad`` and ``splat_trilinear`` called as the card's checks
    call them, C = 2 and bfloat16 values included."""
    vol, grid, _ = case_inputs(rng, "batch_channels")
    ct = rng.rand(*vol.shape).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        v, c = t(vol).to(dtype), t(ct).to(dtype)
        vj, cj = jnp.asarray(v.float().numpy()), jnp.asarray(c.float().numpy())
        _, pull = jax.vjp(lambda a, g: jops.grid_sample(a, g), vj,
                          jnp.asarray(grid))
        gv_ref, gg_ref = pull(cj)
        dgrid = warp_grid_grad(v, t(grid), c)
        dvol = splat_trilinear(c, t(grid), (D, H, W))
        assert dgrid.dtype == dvol.dtype == torch.float32
        np.testing.assert_allclose(dvol.numpy(), np.asarray(gv_ref),
                                   atol=1e-5)
        np.testing.assert_allclose(dgrid.numpy(), np.asarray(gg_ref),
                                   atol=1e-4, rtol=1e-4)


def test_inner_product_identity_and_values_adjoint(rng):
    """<warp(v), c> = <v, splat(c)>, and ``warp_values_adjoint`` is that
    splat (the JAX package's, on the same inputs)."""
    vol, grid, _ = case_inputs(rng, "batch_channels")
    ct = rng.rand(*vol.shape).astype(np.float32)
    warped = warp_trilinear(t(vol), t(grid)).double()
    splat = splat_trilinear(t(ct), t(grid), (D, H, W))
    lhs = (warped * t(ct).double()).sum().item()
    rhs = (t(vol).double() * splat.double()).sum().item()
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)
    adj = ops.warp_values_adjoint(
        lambda v, g: grid_sample(v, g, max_disp=None), t(ct), t(grid))
    np.testing.assert_allclose(adj.numpy(), splat.numpy(), atol=1e-6)
    ref = jops.warp_values_adjoint(jops.grid_sample, jnp.asarray(ct),
                                   jnp.asarray(grid))
    np.testing.assert_allclose(adj.numpy(), np.asarray(ref), atol=1e-5)


def test_values_mode_and_needs_input_grad(rng):
    vol, grid, _ = case_inputs(rng, "smooth")
    v = t(vol).requires_grad_(True)
    g = t(grid).requires_grad_(True)
    grid_sample(v, g, max_disp=R, grad="values").sum().backward()
    assert g.grad is None and v.grad is not None
    full = t(vol).requires_grad_(True)
    grid_sample(full, t(grid), max_disp=R).sum().backward()
    np.testing.assert_array_equal(full.grad.numpy(), v.grad.numpy())
    # a constant volume (the moving image of a registration step) gets none
    g2 = t(grid).requires_grad_(True)
    out = grid_sample(t(vol), g2, max_disp=R)
    out.sum().backward()
    assert g2.grad is not None
    with pytest.raises(ValueError, match="grad must be"):
        grid_sample(t(vol), t(grid), grad="grid")


def test_wrappers_refuse_bad_operands(rng):
    vol, grid, _ = case_inputs(rng, "smooth")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        warp_trilinear(t(vol).double(), t(grid))
    with pytest.raises(TypeError, match="grid must be float32"):
        warp_trilinear(t(vol), t(grid).double())
    with pytest.raises(ValueError, match="contiguous"):
        warp_trilinear(t(vol)[:, :, ::2], t(grid))
    with pytest.raises(ValueError, match="expected"):
        warp_trilinear(t(vol)[0], t(grid))
    with pytest.raises(ValueError, match="grid's points"):
        splat_trilinear(t(vol)[:, :5].contiguous(), t(grid), (D, H, W))
    counts = kernels.launch_counts()
    assert {"warp_trilinear", "warp_grid_grad",
            "splat_trilinear"} <= set(counts)
    assert counts["warp_trilinear"] == 0        # the CPU launches nothing


def test_warp_lncc_loss_matches_jax(rng):
    """The warp + LNCC composition against the JAX package's (Pallas warp in
    interpret mode), and its grid gradient against ``jax.grad`` of the XLA
    composition on the clamped grid.  LNCC's cancelling window sums: 1e-5 on
    the value, 2% of the largest entry on the gradient."""
    from deepatlas_tpu.losses import lncc_loss as jax_lncc
    from deepatlas_tpu.pallas import warp_lncc_loss as jax_warp_lncc
    from deepatlas_torch.kernels import warp_lncc_loss

    moving = rng.rand(1, D, H, W, 1).astype(np.float32)
    fixed = np.clip(0.7 * moving + 0.3 * rng.rand(1, D, H, W, 1), 0,
                    1).astype(np.float32)
    grid = (make_field(rng, 2.0 * R) + identity(1)).astype(np.float32)
    ref = jax_warp_lncc(jnp.asarray(moving), jnp.asarray(fixed),
                        jnp.asarray(grid), filter_size=5, max_disp=R,
                        z_tile=TZ, interpret=True)
    g = t(grid).requires_grad_(True)
    got = warp_lncc_loss(t(moving), t(fixed), g, filter_size=5, max_disp=R)
    assert abs(got.item() - float(ref)) <= 1e-5
    got.backward()
    gref = jax.grad(lambda a: jax_lncc(
        xla_reference(moving, a, R), jnp.asarray(fixed), filter_size=5))(
            jnp.asarray(grid))
    assert np.abs(g.grad.numpy() - np.asarray(gref)).max() \
        <= 2e-2 * np.abs(np.asarray(gref)).max()


# ------------------------------------------------- the ops around the warp

def test_warp_clamp_overflow_and_labels(rng):
    disp = make_field(rng, 2.0 * R)
    grid = (disp + identity(1)).astype(np.float32)
    np.testing.assert_allclose(
        ops.clamp_displacement(t(grid), R).numpy(),
        np.asarray(jops.clamp_displacement(jnp.asarray(grid), R)), atol=1e-7)
    np.testing.assert_allclose(
        ops.displacement_overflow(t(grid), R).item(),
        float(jops.displacement_overflow(jnp.asarray(grid), R)), atol=1e-6)
    vol = rng.rand(1, D, H, W, 2).astype(np.float32)
    small = make_field(rng, 1.5)
    np.testing.assert_allclose(
        ops.warp(t(vol), t(small)).numpy(),
        np.asarray(jops.warp(jnp.asarray(vol), jnp.asarray(small))),
        atol=1e-5)
    labels = rng.randint(0, 5, (1, D, H, W)).astype(np.int32)
    deform = (make_field(rng, 3.0) + identity(1)).astype(np.float32)
    ref = np.asarray(jops.warp_labels(jnp.asarray(labels),
                                      jnp.asarray(deform)))
    got = ops.warp_labels(t(labels), t(deform))
    assert got.dtype == torch.int32
    # round-half-to-even on both sides; a coordinate within float rounding
    # of a half may land on either neighbour
    assert (got.numpy() != ref).mean() < 1e-4
    near = ops.grid_sample(t(vol), t(deform), mode="nearest").numpy()
    nref = np.asarray(jops.grid_sample(jnp.asarray(vol), jnp.asarray(deform),
                                       mode="nearest"))
    assert (near != nref).mean() < 1e-4
    with pytest.raises(ValueError, match="Unknown warp mode"):
        ops.grid_sample(t(vol), t(deform), mode="cubic")
