"""deepatlas_torch UNet_light against the JAX package's UNet_light.

The JAX standard model's variables (randomized with numpy: weights, biases,
BatchNorm affine and running statistics) are converted with
``unet_from_flax`` from the standard tree and from the packed tree that
``transfer_unet_params`` derives from it, and both nets run the same input
in eval mode.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.models import UNet as JaxUNet
from deepatlas_tpu.models import UNetLight as JaxUNetLight
from deepatlas_tpu.models import \
    get_available_networks as jax_get_available_networks
from deepatlas_tpu.models.packed import transfer_unet_params
from deepatlas_torch.models import (UNetLight, get_available_networks,
                                    get_network, unet_from_flax)

VOL = (1, 16, 24, 16, 1)
NC = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(variables, rng):
    """Every leaf of a flax UNet tree drawn from ``rng`` at a scale that
    keeps activations O(1), with positive running variances."""
    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan = np.prod(shape[:-1])
            a = rng.randn(*shape) / np.sqrt(fan)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1 + 0.2 * rng.randn(*shape)
        else:                                   # bias, BN bias, mean
            a = 0.2 * rng.randn(*shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(230)
    x = rng.rand(*VOL).astype(np.float32)
    jax_model = JaxUNetLight(in_channel=1, n_classes=NC, bias=True, BN=True)
    variables = jax.jit(jax_model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = randomize(dict(variables), rng)
    model = UNetLight(in_channel=1, n_classes=NC, bias=True, BN=True).eval()
    model.load_state_dict(unet_from_flax(variables, model))
    return x, jax_model, variables, model


def test_standard_tree_matches_jax_f32(nets):
    x, jax_model, variables, model = nets
    ref = np.asarray(jax.jit(jax_model.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == VOL[:4] + (NC,)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("packed_levels", [1, 2, 3])
def test_packed_tree_converts_to_the_same_weights(nets, packed_levels):
    """infer_seg.py restores packed trees by default; every packed_levels
    variant maps onto the same port weights (so the same logits)."""
    x, _, variables, model = nets
    pk_model = JaxUNetLight(in_channel=1, n_classes=NC, bias=True, BN=True,
                            packed=True, packed_levels=packed_levels)
    pk_vars = transfer_unet_params(variables, pk_model)
    assert any(k.startswith("PackedDeconvBlock") for k in pk_vars["params"])
    twin = UNetLight(in_channel=1, n_classes=NC, bias=True, BN=True).eval()
    twin.load_state_dict(unet_from_flax(pk_vars, twin))
    for (k, a), b in zip(model.state_dict().items(),
                         twin.state_dict().values()):
        assert torch.equal(a, b), k
    with torch.inference_mode():
        np.testing.assert_array_equal(twin(torch.from_numpy(x)).numpy(),
                                      model(torch.from_numpy(x)).numpy())


def test_bf16_matches_jax(nets):
    """bf16 compute: both nets round activations to bf16 after every op,
    but at different points (flax's standard BatchNorm normalizes in
    float32, the port follows the packed blocks' bf16 affine), and 15
    layers compound those half-ulp (2^-9) differences.  Hold the logits to
    5% of their range and the labels to 97% agreement."""
    x, _, variables, model = nets
    jax_bf16 = JaxUNetLight(in_channel=1, n_classes=NC, bias=True, BN=True,
                            dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(jax_bf16.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False), dtype=np.float32)
    model.dtype = torch.bfloat16
    try:
        with torch.inference_mode():
            out = model(torch.from_numpy(x))
    finally:
        model.dtype = None
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 5e-2 * scale
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.97


def test_registry_and_param_count(nets):
    x, _, variables, model = nets
    assert get_available_networks() == jax_get_available_networks()
    assert get_network("UNet_light") is UNetLight
    # the fixed UNet builds from the registry and computes the JAX logits
    jax_unet = JaxUNet(in_channel=1, n_classes=NC, bias=True, BN=True)
    unet_vars = randomize(dict(jax.jit(jax_unet.init,
                                       static_argnames="train")(
        jax.random.PRNGKey(1), jnp.asarray(x), train=False)),
        np.random.RandomState(5))
    unet = get_network("UNet")(in_channel=1, n_classes=NC, bias=True,
                               BN=True).eval()
    unet.load_state_dict(unet_from_flax(unet_vars, unet))
    ref = np.asarray(jax_unet.apply(unet_vars, jnp.asarray(x), train=False))
    with torch.inference_mode():
        out = unet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(),
                               rtol=0)
    with pytest.raises(KeyError):
        get_network("nope")
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(
        variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_flax


def test_train_mode_and_bad_trees_raise(nets):
    """Train mode runs on the batch statistics, matches the JAX model's
    train-mode logits and moves the running statistics as flax does; trees
    that do not fit the model raise."""
    x, jax_model, variables, model = nets
    twin = copy.deepcopy(model)
    out = twin(torch.from_numpy(x), train=True)
    assert out.requires_grad
    ref, mutated = jax.jit(
        lambda v, a: jax_model.apply(v, a, train=True,
                                     mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=5e-4, rtol=5e-4)
    want = unet_from_flax({"params": variables["params"],
                           "batch_stats": mutated["batch_stats"]}, twin)
    moved = 0
    for k, v in twin.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
        moved += not torch.equal(v, model.state_dict()[k])
    assert moved == 2 * 17              # every BatchNorm's mean and variance
    other = UNetLight(in_channel=1, n_classes=NC + 1, bias=True, BN=True)
    with pytest.raises(ValueError, match="shape"):
        unet_from_flax(variables, other)
    no_bn = UNetLight(in_channel=1, n_classes=NC, bias=True, BN=False)
    with pytest.raises(ValueError, match="keys differ"):
        unet_from_flax(variables, no_bn)
