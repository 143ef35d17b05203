"""deepatlas_torch's cross-entropy family against deepatlas_tpu's: the
values and the gradients (``jax.grad``) of ``cross_entropy_loss``,
``soft_cross_entropy_loss`` and ``focal_loss`` in float32, held to 1e-5
(relative to the largest entry for gradients), through the functions and
through the registry's factories with the JAX factories' keywords."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu import losses as jlosses
from deepatlas_torch import losses

SHAPE = (2, 5, 6, 4)
NC = 5
TOL = 1e-5


@pytest.fixture
def inputs(rng):
    logits = (rng.randn(*SHAPE, NC) * 2).astype(np.float32)
    target = rng.randint(0, NC, SHAPE).astype(np.int32)
    return logits, target


def check(torch_fn, jax_fn, pred, *rest):
    """Value and gradient with respect to ``pred`` of both functions."""
    ref, gref = jax.value_and_grad(jax_fn)(jnp.asarray(pred),
                                           *map(jnp.asarray, rest))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = torch_fn(p, *map(torch.from_numpy, rest))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL, atol=TOL)
    gref = np.asarray(gref)
    np.testing.assert_allclose(p.grad.numpy(), gref, rtol=0,
                               atol=TOL * np.abs(gref).max())


def test_cross_entropy(inputs):
    check(losses.cross_entropy_loss, jlosses.cross_entropy_loss, *inputs)
    check(losses.get_loss_function("cross_entropy")(),
          jlosses.get_loss_function("cross_entropy")(), *inputs)


@pytest.mark.parametrize("softmax", [True, False])
def test_soft_cross_entropy(inputs, rng, softmax):
    logits, target = inputs
    pred = logits if softmax else \
        np.array(jax.nn.softmax(logits, axis=-1), np.float32)
    for kw in ({"softmax": softmax}, {"softmax": softmax, "n_class": NC}):
        check(losses.get_loss_function("soft_cross_entropy")(**kw),
              jlosses.get_loss_function("soft_cross_entropy")(**kw),
              pred, target)
    soft = rng.dirichlet(np.ones(NC), SHAPE).astype(np.float32)
    check(lambda p, t: losses.soft_cross_entropy_loss(p, t, softmax=softmax),
          lambda p, t: jlosses.soft_cross_entropy_loss(p, t, softmax=softmax),
          pred, soft)


@pytest.mark.parametrize("alpha", [None, [0.1, 0.2, 0.3, 0.25, 0.15]])
@pytest.mark.parametrize("gamma", [0.0, 2.0, 3.5])
@pytest.mark.parametrize("size_average", [True, False])
def test_focal(inputs, alpha, gamma, size_average):
    kw = {"class_num": NC, "alpha": alpha, "gamma": gamma,
          "size_average": size_average}
    check(losses.get_loss_function("focal")(**kw),
          jlosses.get_loss_function("focal")(**kw), *inputs)


def test_focal_is_the_standard_form(inputs):
    """-alpha_t (1 - p_t)^gamma log p_t: gamma 0 without alpha is the cross
    entropy; the modulating factor shrinks the loss of confident voxels."""
    logits, target = (torch.from_numpy(a) for a in inputs)
    ce = losses.cross_entropy_loss(logits, target)
    torch.testing.assert_close(
        losses.focal_loss(logits, target, NC, gamma=0.0), ce)
    assert losses.focal_loss(logits, target, NC, gamma=2.0) < ce
