"""The registration losses, the windowed sums and the Jacobian metric of
deepatlas_torch against the JAX package, with their gradients, on the CPU.

The same numpy arrays go through both packages.  Tolerances: the window
sums are float32 prefix sums taken in another order (XLA's cumsum is a
parallel scan, torch's runs along the axis), so sums of up to 729 values in
[0, 1] agree to 1e-4 absolute.  LNCC takes differences of such sums that
nearly cancel (``i2_sum - 2 i_mean i_sum + ...``) and divides by their
product plus 1e-6, so on [0, 1] images its value is held to 1e-5 and its
gradient to 2% of the largest entry plus nothing more: flat windows, where
the variance is rounding noise, dominate the difference.  NCC, MSE, the
regularizers and the Jacobian are plain reductions: 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu import losses as jlosses
from deepatlas_tpu import metrics as jmetrics
from deepatlas_tpu.ops import window_sum as jax_window_sum
from deepatlas_torch import losses, metrics
from deepatlas_torch.ops import window_sum

SHAPE = (2, 14, 12, 16, 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(rng, shape=SHAPE):
    """Two correlated smooth-ish images in [0, 1]."""
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(0.7 * a + 0.3 * rng.rand(*shape), 0, 1).astype(np.float32)
    return a, b


def both(fn, jfn, arrays, grad_of=0):
    """Value and gradient (w.r.t. ``arrays[grad_of]``) in both packages."""
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    ts[grad_of].requires_grad_(True)
    val = fn(*ts)
    val.backward()
    jval, jgrad = jax.value_and_grad(jfn, argnums=grad_of)(
        *[jnp.asarray(a) for a in arrays])
    return val.item(), ts[grad_of].grad.numpy(), float(jval), \
        np.asarray(jgrad)


@pytest.mark.parametrize("window,stride,dilation", [
    (9, 1, 1), ((3, 5, 4), 1, 1), (3, 2, 2), ((4, 3, 5), (2, 1, 3), (1, 2, 1)),
    (5, 1, 2)], ids=["prefix9", "prefix_mixed", "strided_dilated", "mixed",
                     "dilated"])
def test_window_sum_matches_jax_and_conv(rng, window, stride, dilation):
    x = rng.rand(2, 14, 12, 16, 3).astype(np.float32)
    ref = np.asarray(jax_window_sum(jnp.asarray(x), window, stride, dilation))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = window_sum(xt, window, stride, dilation)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4)
    # the ones-kernel convolution it stands for
    win = (window,) * 3 if isinstance(window, int) else window
    lib = torch.nn.functional.conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3).reshape(6, 1, 14, 12, 16),
        torch.ones(1, 1, *win), stride=stride, dilation=dilation)
    np.testing.assert_allclose(
        got.detach().numpy(),
        lib.reshape(2, 3, *lib.shape[2:]).permute(0, 2, 3, 4, 1).numpy(),
        atol=1e-4, rtol=3e-6)   # a prefix sum carries its running total's ulp
    ct = rng.rand(*ref.shape).astype(np.float32)
    (got * torch.from_numpy(ct)).sum().backward()
    gref = jax.grad(lambda a: jnp.sum(
        jax_window_sum(a, window, stride, dilation) * ct))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), atol=1e-4)
    with pytest.raises(ValueError, match="length-3"):
        window_sum(xt, (3, 3))


def test_window_sum_refuses_a_window_that_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        window_sum(torch.zeros(1, 4, 4, 4, 1), 5, 2, 1)


@pytest.mark.parametrize("filter_size", [9, 5])
def test_lncc_loss_and_gradient(rng, filter_size):
    a, b = images(rng)
    val, grad, jval, jgrad = both(
        lambda x, y: losses.lncc_loss(x, y, filter_size=filter_size),
        lambda x, y: jlosses.lncc_loss(x, y, filter_size=filter_size), (a, b))
    assert abs(val - jval) <= 1e-5
    assert np.abs(grad - jgrad).max() <= 2e-2 * np.abs(jgrad).max()
    assert 0.0 < val < 1.0
    same = torch.from_numpy(a)
    assert losses.lncc_loss(same, same, filter_size).item() < 1e-3


@pytest.mark.parametrize("shape", [(1, 140, 10, 12, 1), (1, 70, 10, 12, 1),
                                   (2, 14, 12, 16, 1)],
                         ids=["three_scales", "two_scales", "one_scale"])
def test_multiscale_lncc_loss_and_gradient(rng, shape):
    a, b = images(rng, shape)
    assert losses.similarity.multiscale_lncc_schedule(shape[1:4]) == \
        jlosses.similarity.multiscale_lncc_schedule(shape[1:4])
    val, grad, jval, jgrad = both(losses.multiscale_lncc_loss,
                                  jlosses.multiscale_lncc_loss, (a, b))
    assert abs(val - jval) <= 1e-5
    assert np.abs(grad - jgrad).max() <= 2e-2 * np.abs(jgrad).max()


@pytest.mark.parametrize("name", ["ncc", "mse"])
def test_global_similarity_losses(rng, name):
    a, b = images(rng)
    fn = losses.get_loss_function(name)()
    jfn = jlosses.get_loss_function(name)()
    val, grad, jval, jgrad = both(fn, jfn, (a, b))
    np.testing.assert_allclose(val, jval, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4,
                               atol=1e-6 * np.abs(jgrad).max())


@pytest.mark.parametrize("name,settings", [
    ("bendingEnergy", {}),
    ("bendingEnergy", {"spacing": (1.0, 1.5, 2.0)}),
    ("bendingEnergy", {"norm": "L1", "normalize": False}),
    ("gradient", {}),
    ("gradient", {"spacing": (2.0, 1.0, 1.5), "normalize": False}),
    ("gradient", {"norm": "L1"}),
    ("L2", {}),
], ids=["bending", "bending_spacing", "bending_l1", "gradient",
        "gradient_spacing", "gradient_l1", "l2"])
def test_regularizers_and_their_gradients(rng, name, settings):
    field = (0.05 * rng.randn(2, 9, 11, 8, 3)).astype(np.float32)
    fn = losses.get_loss_function(name)(**settings)
    jfn = jlosses.get_loss_function(name)(**settings)
    val, grad, jval, jgrad = both(fn, jfn, (field,))
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4,
                               atol=1e-6 * np.abs(jgrad).max())


def test_jacobian_determinant_and_folding(rng):
    from deepatlas_tpu.ops import identity_grid_batch
    ident = np.asarray(identity_grid_batch((2, 9, 11, 8, 3)))
    deform = (ident + 0.25 * rng.randn(2, 9, 11, 8, 3)).astype(np.float32)
    det = metrics.jacobian_determinant(torch.from_numpy(deform))
    ref = np.asarray(jmetrics.jacobian_determinant(jnp.asarray(deform)))
    assert det.shape == (2, 7, 9, 6)
    np.testing.assert_allclose(det.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        metrics.jacobian_determinant(torch.from_numpy(ident.copy())).numpy(), 1.0,
        atol=1e-5)
    stats = metrics.folding_stats(torch.from_numpy(deform))
    jstats = jmetrics.folding_stats(jnp.asarray(deform))
    assert set(stats) == set(jstats)
    assert 0.0 < stats["folding_fraction"].item() < 1.0
    for key in stats:
        np.testing.assert_allclose(stats[key].item(), float(jstats[key]),
                                   rtol=1e-4, atol=1e-5)
    d = torch.from_numpy(deform).requires_grad_(True)
    metrics.jacobian_determinant(d).sum().backward()
    gref = jax.grad(lambda a: jnp.sum(jmetrics.jacobian_determinant(a)))(
        jnp.asarray(deform))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gref), rtol=1e-4,
                               atol=1e-4)


def test_registration_keys_of_the_loss_registry():
    ported = ("ncc", "lncc", "mse", "gradient", "bendingEnergy", "dice", "L2")
    assert losses.get_available_losses() == ported
    # in the JAX registry's order
    assert [k for k in jlosses.get_available_losses() if k in ported] \
        == list(ported)
    lncc = losses.get_loss_function("lncc")(filter_size=5, eps=1e-5)
    assert lncc.keywords == {"filter_size": 5, "eps": 1e-5}
    for name in ("focal", "cross_entropy", "soft_cross_entropy"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            losses.get_loss_function(name)
