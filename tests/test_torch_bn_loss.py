"""Train-mode BatchNorm, the dice losses and multiclass_dice of
deepatlas_torch against the JAX package, on the same numpy inputs.

Tolerances: float32 on both sides with the same formulas, so values and
gradients differ by summation order only: 1e-5 absolute and relative at O(1)
values (2e-5 of the largest entry for gradients that sum over every voxel).
bfloat16 BatchNorm: moments are float32 on both sides, the affine map runs
in bf16, so outputs agree to one bf16 rounding (2^-7 relative).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from deepatlas_tpu.losses import (dice_loss_multiclass as jax_dice,
                                  dice_loss_on_label as jax_dice_on_label,
                                  get_loss_function as jax_get_loss,
                                  soft_dice_on_probs as jax_soft_dice)
from deepatlas_tpu.metrics import multiclass_dice as jax_multiclass_dice
from deepatlas_tpu.models.packed import PackedBatchNorm
from deepatlas_torch.losses import (dice_loss_multiclass, dice_loss_on_label,
                                    get_available_losses, get_loss_function,
                                    soft_dice_on_probs)
from deepatlas_torch.metrics import multiclass_dice
from deepatlas_torch.models import BatchNorm
from deepatlas_torch.ops import one_hot

C = 8
SHAPE = (2, 4, 5, 6, C)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bn_inputs(rng):
    x = (rng.randn(*SHAPE) * 1.5 + 0.7).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.3 * rng.randn(C)).astype(np.float32)
    mean0 = (0.1 * rng.randn(C)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    ct = rng.randn(*SHAPE).astype(np.float32)
    return x, scale, bias, mean0, var0, ct


def torch_bn(x, scale, bias, mean0, var0, ct, dtype, calls):
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    for _ in range(calls):
        y = bn(xt, train=True)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return (y.detach().float().numpy(), xt.grad.float().numpy(),
            bn.weight.grad.numpy(), bn.bias.grad.numpy(),
            bn.running_mean.numpy(), bn.running_var.numpy())


def jax_bn(module, pack, x, scale, bias, mean0, var0, ct, dtype, calls,
           **call_kw):
    """Output, gradients and running statistics of a flax BatchNorm-like
    ``module`` after ``calls`` training calls."""
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    xin = jnp.asarray(x).astype(dtype)

    def apply(params, stats, xin):
        return module.apply({"params": params, "batch_stats": stats},
                            pack(xin), mutable=["batch_stats"], **call_kw)

    stats = variables["batch_stats"]
    for _ in range(calls):
        y, mutated = apply(variables["params"], stats, xin)
        stats = mutated["batch_stats"]

    def loss(params, xin):
        y, _ = apply(params, variables["batch_stats"], xin)
        return jnp.sum(y.reshape(x.shape).astype(jnp.float32)
                       * jnp.asarray(ct))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], xin)
    f = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return (f(y).reshape(x.shape), f(gx), f(gp["scale"]), f(gp["bias"]),
            f(stats["mean"]), f(stats["var"]))


def flax_module():
    return nn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)


def packed_module(dtype=None):
    b, d, h, w, c = SHAPE
    return PackedBatchNorm(c, b * d * h * w, dtype=dtype)


def pack(xin):
    b, d, h, w, c = xin.shape
    return xin.reshape(b, d, h, w * c)


def check_bn(got, ref, tol):
    names = ("y", "dx", "dscale", "dbias", "running_mean", "running_var")
    for name, a, b in zip(names, got, ref):
        scale = max(np.abs(b).max(), 1e-6)
        err = np.abs(a - b).max()
        assert err <= tol * scale, f"{name}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("calls", [1, 2])
@pytest.mark.parametrize("reference", ["flax", "packed"])
def test_train_batchnorm_matches_jax_f32(rng, reference, calls):
    """Output, input / scale / bias gradients, and the running mean and
    *biased* running variance after one and two calls."""
    inputs = bn_inputs(rng)
    got = torch_bn(*inputs, torch.float32, calls)
    if reference == "flax":
        ref = jax_bn(flax_module(), lambda a: a, *inputs, jnp.float32, calls)
    else:
        ref = jax_bn(packed_module(), pack, *inputs, jnp.float32, calls,
                     train=True)
    check_bn(got, ref, 2e-5)
    # the biased variance, not torch.nn.BatchNorm3d's unbiased one
    x, _, _, _, var0, _ = inputs
    biased = x.reshape(-1, C).var(axis=0)
    want = var0
    for _ in range(calls):
        want = 0.9 * want + 0.1 * biased
    np.testing.assert_allclose(got[5], want, rtol=1e-5)


def test_train_batchnorm_matches_packed_bf16(rng):
    inputs = bn_inputs(rng)
    got = torch_bn(*inputs, torch.bfloat16, 1)
    ref = jax_bn(packed_module(jnp.bfloat16), pack, *inputs, jnp.bfloat16, 1,
                 train=True)
    check_bn(got[:1], ref[:1], 2 ** -7)          # one bf16 rounding
    check_bn(got[1:4], ref[1:4], 2e-2)           # bf16 products summed
    check_bn(got[4:], ref[4:], 1e-5)             # float32 moments


def test_eval_batchnorm_leaves_running_stats(rng):
    x, scale, bias, mean0, var0, _ = bn_inputs(rng)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn(torch.from_numpy(x), train=False)
    np.testing.assert_array_equal(bn.running_mean.numpy(), mean0)
    np.testing.assert_array_equal(bn.running_var.numpy(), var0)


# ------------------------------------------------------------------ dice

NC = 5
VOL = (2, 6, 7, 8)


def dice_inputs(rng):
    logits = rng.randn(*VOL, NC).astype(np.float32) * 2
    target = rng.randint(0, NC, VOL).astype(np.int32)
    target[0][target[0] == 3] = 0       # a class absent from one volume
    return logits, target


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("no_bg", [False, True])
@pytest.mark.parametrize("weight_type", ["Uniform", "Simple", "Volume"])
def test_dice_loss_multiclass_value_and_grad(rng, weight_type, no_bg,
                                             softmax):
    logits, target = dice_inputs(rng)
    if not softmax:
        logits = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    kw = dict(n_class=NC, weight_type=weight_type, no_bg=no_bg,
              softmax=softmax, eps=1e-6)
    ref, gref = jax.value_and_grad(
        lambda s: jax_dice(s, jnp.asarray(target), **kw))(jnp.asarray(logits))
    src = torch.from_numpy(logits).requires_grad_()
    got = dice_loss_multiclass(src, torch.from_numpy(target), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=1e-5)
    gref = np.asarray(gref)
    assert np.abs(src.grad.numpy() - gref).max() <= 2e-5 * np.abs(gref).max()


def test_dice_loss_multiclass_one_hot_target_and_bad_shape(rng):
    logits, target = dice_inputs(rng)
    kw = dict(n_class=NC, weight_type="Uniform", softmax=True, eps=1e-6)
    oh = np.eye(NC, dtype=np.float32)[target]
    ref = jax_dice(jnp.asarray(logits), jnp.asarray(oh), **kw)
    got = dice_loss_multiclass(torch.from_numpy(logits), torch.from_numpy(oh),
                               **kw)
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=1e-5)
    int_target = dice_loss_multiclass(torch.from_numpy(logits),
                                      torch.from_numpy(target), **kw)
    np.testing.assert_allclose(got.item(), int_target.item(), atol=1e-6)
    uint8_target = dice_loss_multiclass(
        torch.from_numpy(logits), torch.from_numpy(target.astype(np.uint8)),
        **kw)
    assert uint8_target.item() == int_target.item()
    with pytest.raises(ValueError, match="Incorrect target shape"):
        dice_loss_multiclass(torch.from_numpy(logits),
                             torch.from_numpy(target[..., 0]), **kw)
    with pytest.raises(ValueError, match="does not exist"):
        dice_loss_multiclass(torch.from_numpy(logits),
                             torch.from_numpy(target), NC, weight_type="x")


@pytest.mark.parametrize("weight_type", ["Uniform", "Simple"])
def test_dice_loss_on_label(rng, weight_type):
    _, a = dice_inputs(rng)
    b = np.where(rng.rand(*VOL) < 0.7, a, rng.randint(0, NC, VOL)).astype(
        np.int32)
    ref = jax_dice_on_label(jnp.asarray(a), jnp.asarray(b), NC,
                            weight_type=weight_type)
    got = dice_loss_on_label(torch.from_numpy(a), torch.from_numpy(b), NC,
                             weight_type=weight_type)
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-5)


def test_soft_dice_on_probs_value_and_grad(rng):
    logits, target = dice_inputs(rng)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ref, gref = jax.value_and_grad(
        lambda p: jax_soft_dice(p, jnp.asarray(target), NC))(
            jnp.asarray(probs))
    src = torch.from_numpy(probs).requires_grad_()
    got = soft_dice_on_probs(src, torch.from_numpy(target), NC)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-5)
    gref = np.asarray(gref)
    assert np.abs(src.grad.numpy() - gref).max() <= 2e-5 * np.abs(gref).max()


def test_multiclass_dice_and_one_hot(rng):
    _, truth = dice_inputs(rng)
    pred = np.where(rng.rand(*VOL) < 0.6, truth,
                    rng.randint(0, NC, VOL)).astype(np.int32)
    ref = np.asarray(jax_multiclass_dice(jnp.asarray(pred),
                                         jnp.asarray(truth), NC))
    got = multiclass_dice(torch.from_numpy(pred), torch.from_numpy(truth), NC)
    assert got.shape == (VOL[0], NC - 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    oh = one_hot(torch.from_numpy(truth), NC)
    np.testing.assert_array_equal(
        oh.numpy(), np.asarray(jax.nn.one_hot(truth, NC)))
    # out of range -> an all-zero row, as jax.nn.one_hot
    assert one_hot(torch.tensor([NC, -1]), NC).sum().item() == 0


def test_loss_registry(rng):
    assert "dice" in get_available_losses()
    logits, target = dice_inputs(rng)
    settings = {"n_class": NC, "weight_type": "Uniform", "no_bg": False,
                "softmax": True, "eps": 1e-6}
    ref = jax_get_loss("dice")(**settings)(jnp.asarray(logits),
                                           jnp.asarray(target))
    got = get_loss_function("dice")(**settings)(torch.from_numpy(logits),
                                                torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=1e-5)
    for name in ("focal", "cross_entropy", "soft_cross_entropy"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_loss_function(name)
    with pytest.raises(KeyError):
        get_loss_function("nope")
