"""The port's weight init against flax's, by its statistics, on the CPU.

``deepatlas_torch.models.layers.glorot_normal_`` stands in for
``flax.linen.initializers.glorot_normal()`` (variance scaling 1.0, fan
average, truncated normal): the port's from-scratch runs start from it.
The two frameworks draw different numbers from their seeds, so the test
compares distributions at UNet_light's 3x3x3x32x64 kernel (55,296 draws):
the standard deviation ``sqrt(2 / (fan_in + fan_out))``, the mean, the
truncation at 2 / 0.8796 = 2.27 standard deviations, and the quantiles of
``|w|``.  Limits: the std of 55,296 draws has a relative standard error of
about 0.3%, so 2% against the formula and 3% between the two; quantiles
within 0.03 of one standard deviation.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from deepatlas_torch.models.layers import glorot_normal_

SHAPE = (3, 3, 3, 32, 64)
FAN_IN, FAN_OUT = 27 * 32, 27 * 64
STD = math.sqrt(2.0 / (FAN_IN + FAN_OUT))
TRUNC = 2.0 / .87962566103423978  # flax's truncation, in units of STD


@pytest.fixture(scope="module")
def draws():
    torch.manual_seed(0)
    port = glorot_normal_(torch.empty(SHAPE)).numpy().astype(np.float64)
    ref = np.asarray(nn.initializers.glorot_normal()(
        jax.random.PRNGKey(0), SHAPE, jnp.float32)).astype(np.float64)
    return port, ref


def test_glorot_normal_std_and_mean_match_flax(draws):
    port, ref = draws
    assert port.shape == ref.shape == SHAPE
    for w in (port, ref):
        assert abs(w.std() / STD - 1) < 0.02
        assert abs(w.mean()) < 4 * STD / math.sqrt(w.size)
    assert abs(port.std() / ref.std() - 1) < 0.03


def test_glorot_normal_truncation_matches_flax(draws):
    port, ref = draws
    for w in (port, ref):
        top = np.abs(w).max() / STD
        # truncated at 2.27 std, and drawn up to near that edge
        assert top <= TRUNC * (1 + 1e-5)
        assert top >= 0.97 * TRUNC
    qs = (0.5, 0.9, 0.99)
    got = np.quantile(np.abs(port), qs) / STD
    want = np.quantile(np.abs(ref), qs) / STD
    np.testing.assert_allclose(got, want, atol=0.03)
