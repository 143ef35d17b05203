"""The registration slice as a whole: ``make_reg_train_step`` /
``make_reg_eval_step`` of deepatlas_torch against the JAX package's, from
the same weights (``voxelmorph_from_flax``) and the same pair.

The JAX side is the standard (XLA) VoxelMorph with the XLA warp; the port
runs its autograd Functions, whose backward reaches the plain versions of
the conv, weight-gradient and warp grid-gradient kernels on the CPU through
the wrappers the card uses.  Both warp unclamped here (the clamp's forward
and gradient are held in ``tests/test_torch_warp.py``; the JAX package
clamps only on its Pallas path, whose interpret-mode gradients take
minutes); the step is still given the bound, so ``disp_overflow`` is
compared.

Tolerances.  float32: the same formulas in another order of summation
through 11 convs, the warp and LNCC's cancelling window sums: loss, sim and
reg to 1e-5; gradients and Adam's first moments to 2e-3 of each tensor's
largest entry, second moments to twice that; parameters after an Adam step
to 2 lr in every entry (where a gradient is rounding noise Adam's
``m / (sqrt(v) + eps)`` takes the noise's sign, in either package) and to
2e-2 lr in the mean.  Adam makes a free run chaotic at this size, so every
compared step starts from the JAX state, and a port state that runs free is
held to what it could have walked (2.5 times the sum of the learning
rates).  bfloat16: the packages round each layer's output alike but sum in
another order, so single roundings flip and compound over 11 layers and the
warp: losses to 2e-2, gradients to 15% of a tensor's largest entry in the
mean over its entries and 60% at the worst entry.  The biases are left to the
float32 case: flax sums a bf16 bias gradient over the volume's thousands of
voxels in bf16 and lands far from its own float32 value (the port sums in
float32), so it is no reference.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.losses import get_loss_function as jax_get_loss
from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVoxelMorph
from deepatlas_tpu.train.reg_steps import (
    make_reg_eval_step as jax_eval_step,
    make_reg_train_step as jax_train_step)
from deepatlas_tpu.train.steps import (TrainState as JaxTrainState,
                                       make_optimizer as jax_make_optimizer,
                                       set_learning_rate as jax_set_lr)
from deepatlas_torch.losses import get_loss_function
from deepatlas_torch.models import (VoxelMorphCVPR2018, adam_from_optax,
                                    voxelmorph_from_flax)
from deepatlas_torch.train import (TrainState, make_optimizer,
                                   make_reg_eval_step, make_reg_train_step,
                                   set_learning_rate)

VOL = (1, 21, 18, 20, 1)
ENC, DEC = (4, 8, 8, 8, 8), (8, 8, 8, 4, 4)
LR = 1e-3
NC = 4
MAX_DISP = 2
REG_WEIGHT = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def randomize(variables, rng):
    """Random kernels and biases; the flow head scaled to a field of a few
    voxels, so that part of it exceeds ``MAX_DISP``."""
    def draw(path, leaf):
        shape = leaf.shape
        if path[-1].key == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            if shape[-1] == 3:
                a = a * 0.3
        else:
            a = 0.1 * rng.randn(*shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, variables)


def pairs(rng, n):
    """Smooth textured volumes: a fixed image and a shifted, scaled copy
    plus noise, with blocky labels, one pair per step."""
    out = []
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in VOL[1:4]],
                             indexing="ij")
    for _ in range(n):
        ph = rng.uniform(0, 3, 3)
        fixed = 0.5 + 0.25 * (np.sin(0.9 * zz + ph[0]) * np.cos(0.7 * yy + ph[1])
                              + np.sin(0.8 * xx + ph[2]))
        moving = np.roll(fixed, 1, axis=2) * 0.9 + 0.05 * rng.rand(*VOL[1:4])
        mseg = rng.randint(0, NC, VOL[:4]).astype(np.int32)
        fseg = rng.randint(0, NC, VOL[:4]).astype(np.int32)
        out.append((moving.astype(np.float32)[None, ..., None],
                    fixed.astype(np.float32)[None, ..., None], mseg, fseg))
    return out


class Pair:
    """The two packages' train states from one set of random weights."""

    def __init__(self, rng, bf16):
        self.bf16 = bf16
        self.jmodel = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC,
                                    dtype=jnp.bfloat16 if bf16 else None)
        x0 = jnp.zeros(VOL, jnp.float32)
        variables = randomize(dict(jax.jit(self.jmodel.init)(
            jax.random.PRNGKey(0), x0, x0)), rng)
        self.jstate = JaxTrainState.create(
            apply_fn=self.jmodel.apply, params=variables["params"],
            batch_stats={}, tx=jax_make_optimizer(LR))
        self.jsim = jax_get_loss("lncc")(filter_size=9)
        self.jreg = jax_get_loss("bendingEnergy")()
        self.jstep = jax_train_step(self.jsim, self.jreg, REG_WEIGHT,
                                    max_disp=MAX_DISP)
        self.jeval = jax_eval_step(NC)

        self.model = VoxelMorphCVPR2018(
            enc_filters=ENC, dec_filters=DEC, max_disp=None,
            dtype=torch.bfloat16 if bf16 else None)
        self.model.load_state_dict(voxelmorph_from_flax(
            numpy_tree(variables), self.model))
        self.state = TrainState(self.model, make_optimizer(self.model, LR))
        self.step = make_reg_train_step(
            get_loss_function("lncc")(filter_size=9),
            get_loss_function("bendingEnergy")(), REG_WEIGHT,
            max_disp=MAX_DISP)
        self.eval = make_reg_eval_step(NC)

    def jax_grads(self, moving, fixed):
        state = self.jstate

        def loss_fn(params):
            disp, warped, _ = state.apply_fn({"params": params},
                                             jnp.asarray(moving),
                                             jnp.asarray(fixed), train=True)
            return self.jsim(warped.astype(jnp.float32), jnp.asarray(fixed)) \
                + REG_WEIGHT * self.jreg(disp.astype(jnp.float32))

        return jax.grad(loss_fn)(state.params)

    def advance(self, moving, fixed):
        grads = voxelmorph_from_flax(
            {"params": numpy_tree(self.jax_grads(moving, fixed))}, self.model)
        self.jstate, jmetrics = self.jstep(self.jstate, jnp.asarray(moving),
                                           jnp.asarray(fixed))
        self.state, metrics = self.step(self.state, torch.from_numpy(moving),
                                        torch.from_numpy(fixed))
        return ({k: float(v) for k, v in jmetrics.items()},
                {k: float(v) for k, v in metrics.items()}, grads)

    def jax_as_port(self):
        sd = voxelmorph_from_flax(
            {"params": numpy_tree(self.jstate.params)}, self.model)
        adam = numpy_tree(self.jstate.opt_state.inner_state[0])
        mu = voxelmorph_from_flax({"params": adam.mu}, self.model)
        nu = voxelmorph_from_flax({"params": adam.nu}, self.model)
        return sd, mu, nu

    def follow_jax(self):
        sd, _, _ = self.jax_as_port()
        self.model.load_state_dict(sd)
        self.state.optimizer.load_state_dict(adam_from_optax(
            numpy_tree(self.jstate.opt_state), self.model,
            convert=voxelmorph_from_flax))


def rel_err(got, ref, floor=0.0):
    got, ref = got.detach().float().numpy(), ref.float().numpy()
    err = max(np.abs(got - ref).max() - floor, 0.0)
    return err / max(np.abs(ref).max(), 1e-12)


def mean_rel_err(got, ref):
    got, ref = got.detach().float().numpy(), ref.float().numpy()
    return np.abs(got - ref).mean() / max(np.abs(ref).max(), 1e-12)


def check_states(pair, grads, steps_taken, lr):
    sd, mu, nu = pair.jax_as_port()
    opt_state = pair.state.optimizer.state
    for name, p in pair.model.named_parameters():
        if pair.bf16:
            if name.endswith(".bias"):
                continue
            assert rel_err(p.grad, grads[name]) <= 0.6, name
            assert mean_rel_err(p.grad, grads[name]) <= 0.15, name
            continue
        assert rel_err(p.grad, grads[name], 1e-7) <= 2e-3, f"grad {name}"
        assert rel_err(opt_state[p]["exp_avg"], mu[name], 1e-7) <= 2e-3, name
        assert rel_err(opt_state[p]["exp_avg_sq"], nu[name], 1e-14) <= 4e-3, \
            name
        assert int(opt_state[p]["step"]) == steps_taken
        err = (p.detach() - sd[name]).abs()
        assert err.max().item() <= 2.0 * lr, f"param {name}"
        assert err.mean().item() <= 2e-2 * lr, f"param {name}"


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_one_and_three_reg_steps_match_jax(rng, bf16):
    """Three steps with a learning-rate change after the first; the compared
    port state restarts every step from the JAX state, a second one runs
    free from the common start."""
    pair = Pair(rng, bf16)
    free_model = copy.deepcopy(pair.model)
    free = TrainState(free_model, make_optimizer(free_model, LR))
    tol = 2e-2 if bf16 else 1e-5
    lr, lr_sum = LR, 0.0
    for i, (moving, fixed, _, _) in enumerate(pairs(rng, 3)):
        jm, m, grads = pair.advance(moving, fixed)
        free, fm = pair.step(free, torch.from_numpy(moving),
                             torch.from_numpy(fixed))
        lr_sum += lr
        assert set(m) == set(jm) == {"loss", "sim", "reg", "disp_overflow"}
        for key in ("loss", "sim", "reg"):
            assert abs(m[key] - jm[key]) <= tol, (i, key, m[key], jm[key])
            assert abs(float(fm[key]) - jm[key]) <= max(tol, 1e-2)
        assert abs(m["loss"] - (m["sim"] + REG_WEIGHT * m["reg"])) <= 1e-6
        # a voxel within rounding of the bound may count on either side
        assert abs(m["disp_overflow"] - jm["disp_overflow"]) \
            <= (2e-2 if bf16 else 1e-3)
        if i == 0:
            assert 0.0 < jm["disp_overflow"] < 1.0
        assert pair.state.step == free.step == i + 1 == int(pair.jstate.step)
        check_states(pair, grads, i + 1, lr)
        pair.follow_jax()
        if i == 0:
            lr = 2e-4
            pair.jstate = jax_set_lr(pair.jstate, lr)
            for state in (pair.state, free):
                set_learning_rate(state, lr)
    sd, _, _ = pair.jax_as_port()
    for name, p in free_model.named_parameters():
        err = (p.detach() - sd[name]).abs().max().item()
        assert err <= 2.5 * lr_sum, f"free-running param {name}: {err}"


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_reg_eval_step_matches_jax(rng, bf16):
    pair = Pair(rng, bf16)
    (moving, fixed, mseg, fseg), = pairs(rng, 1)
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    jdice, jfold, jwarped = pair.jeval(
        pair.jstate, jnp.asarray(moving), jnp.asarray(fixed),
        jnp.asarray(mseg), jnp.asarray(fseg))
    dice, fold, warped = pair.eval(
        pair.state, torch.from_numpy(moving), torch.from_numpy(fixed),
        torch.from_numpy(mseg), torch.from_numpy(fseg))
    assert dice.shape == (1, NC - 1) and not warped.requires_grad
    # random labels: a sample that rounds to another voxel changes a label,
    # which bf16's coordinate differences do for a few percent of them
    np.testing.assert_allclose(dice.numpy(), np.asarray(jdice),
                               atol=3e-2 if bf16 else 1e-3)
    assert abs(float(fold) - float(jfold)) <= (2e-2 if bf16 else 1e-3)
    assert np.abs(warped.numpy() - np.asarray(jwarped)).max() \
        <= (5e-2 if bf16 else 1e-4)
    for k, v in pair.model.state_dict().items():    # eval changes nothing
        assert torch.equal(v, before[k]), k


def test_adam_state_crosses_for_voxelmorph(rng):
    """Two JAX steps, then the optimizer state crosses with
    ``adam_from_optax(..., convert=voxelmorph_from_flax)`` and both packages
    take a third step."""
    pair = Pair(rng, bf16=False)
    data = pairs(rng, 3)
    for moving, fixed, _, _ in data[:2]:
        pair.jstate, _ = pair.jstep(pair.jstate, jnp.asarray(moving),
                                    jnp.asarray(fixed))
    pair.jstate = jax_set_lr(pair.jstate, 5e-4)
    pair.follow_jax()
    _, mu, nu = pair.jax_as_port()
    adam_sd = pair.state.optimizer.state_dict()
    assert adam_sd["param_groups"][0]["lr"] == pytest.approx(5e-4)
    for i, (name, _) in enumerate(pair.model.named_parameters()):
        assert float(adam_sd["state"][i]["step"]) == 2.0
        assert torch.equal(adam_sd["state"][i]["exp_avg"], mu[name])
        assert torch.equal(adam_sd["state"][i]["exp_avg_sq"], nu[name])
    jm, m, grads = pair.advance(*data[2][:2])
    assert abs(m["loss"] - jm["loss"]) <= 1e-5
    check_states(pair, grads, 3, 5e-4)
