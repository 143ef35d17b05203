"""The segmentation training slice as a whole: ``make_seg_train_step`` /
``make_seg_eval_step`` of deepatlas_torch against the JAX package's, from
the same weights (``unet_from_flax``) and the same batch.

The JAX side is the standard (XLA) UNet_light; the port runs its autograd
Functions, whose backward reaches kernel A's, B's and D's plain versions on
the CPU through the wrappers the card uses.

Tolerances.  float32: both sides compute the same formulas, differing in
summation order; the deepest BatchNorms normalize over 8 voxels, which
amplifies those differences, so gradients and Adam moments are held to 2e-3
of each tensor's largest entry -- or, where the step is ill-conditioned, to
three times the most that a relative change of 1e-7 in the input image
does to any of the port's own gradients (``conditioning``; at one of the three steps below
that alone moves them by 1%) -- the loss to 1e-5, BatchNorm statistics to
1e-4, and parameters after an Adam step to 2e-2 of the learning rate in the
mean over entries and to 2 lr in every entry (Adam's update is
lr * m / (sqrt(v) + eps), about lr in size however small the gradient, so
an entry whose gradient is noise may step either way).  A conv bias in front of a BatchNorm has no gradient at all
(the batch mean removes it): both packages compute rounding noise of about
1e-9 there, which is held to an absolute 1e-7, and Adam turns that noise
into steps of up to lr in either direction in either package.  Because of
those noise-driven steps two free runs drift apart from the second step
on, so every compared step starts from the JAX state, and a free run is
held loosely beside it (``check_free_run``).  bfloat16: the two packages
round at different points (flax's BatchNorm normalizes in float32, the port
follows the packed blocks' bf16 affine; see tests/test_torch_unet.py) and
the roundings compound through the layers, so the comparison runs on a
two-level narrow plan, where the JAX package's own bf16 gradients lie
within 14% (largest entry) and 7% (mean over entries) of its float32 ones;
the port's are held against the JAX bf16 gradients to 60% (largest entry)
and 15% (mean over entries) of each tensor's largest entry, and to 6% in
the mean over all tensors (measured over the three steps: at most 43%, 8%
and 3%; the largest single entries sit in 16-element BatchNorm biases and
change with the order of summation), and the loss to 2e-2.  The head's bias is left to the
float32 case: its gradient sums to zero over the classes, the JAX bf16 run
accumulates it in bf16 and lands 3x off its own float32 value, so it is no
reference.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.losses import get_loss_function as jax_get_loss
from deepatlas_tpu.models import UNetLight as JaxUNetLight
from deepatlas_tpu.models import UNetTemplate as JaxUNetTemplate
from deepatlas_tpu.train.steps import (TrainState as JaxTrainState,
                                       _apply_model,
                                       make_optimizer as jax_make_optimizer,
                                       make_seg_eval_step as jax_eval_step,
                                       make_seg_train_step as jax_train_step,
                                       set_learning_rate as jax_set_lr)
from deepatlas_torch.losses import get_loss_function
from deepatlas_torch.models import (UNetLight, UNetTemplate, adam_from_optax,
                                    unet_from_flax)
from deepatlas_torch.train import (TrainState, make_optimizer,
                                   make_seg_eval_step, make_seg_train_step,
                                   set_learning_rate)

VOL = (1, 16, 16, 16)
NC = 4
LR = 1e-3
# a two-level narrow plan for bfloat16: its deepest BatchNorm still sees 512
# voxels and 7 convs compound fewer roundings than UNet_light's 14
NARROW = dict(encoders=((8, 16), (16, 16, 32)), decoders=((32, 16, 16),),
              act="LeakyReLU")
LOSS = {"n_class": NC, "weight_type": "Uniform", "no_bg": False,
        "softmax": True, "eps": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(variables, rng):
    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1 + 0.2 * rng.randn(*shape)
        else:                                   # bias, BN bias, mean
            a = 0.2 * rng.randn(*shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, variables)


def batches(rng, n):
    """Blocky labels (4^3 blocks) whose intensity follows the label, one
    batch per step."""
    out = []
    for _ in range(n):
        coarse = rng.randint(0, NC, (VOL[0],) + tuple(v // 4 for v in VOL[1:]))
        seg = np.kron(coarse, np.ones((1, 4, 4, 4), int)).astype(np.uint8)
        img = (seg / NC + 0.2 * rng.rand(*VOL)).astype(np.float32)[..., None]
        out.append((img, seg))
    return out


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


class Pair:
    """The two packages' train states from one set of random weights."""

    def __init__(self, rng, bf16, narrow=False):
        self.bf16 = bf16
        jdtype = jnp.bfloat16 if bf16 else None
        jax_net = (lambda **kw: JaxUNetTemplate(**NARROW, **kw)) if narrow \
            else JaxUNetLight
        net = (lambda **kw: UNetTemplate(**NARROW, **kw)) if narrow \
            else UNetLight
        self.jax_model = jax_net(in_channel=1, n_classes=NC, bias=True,
                                 BN=True, dtype=jdtype)
        x0 = jnp.zeros(VOL + (1,), jnp.float32)
        variables = jax.jit(self.jax_model.init, static_argnames="train")(
            jax.random.PRNGKey(0), x0, train=False)
        variables = randomize(dict(variables), rng)
        self.jstate = JaxTrainState.create(
            apply_fn=self.jax_model.apply, params=variables["params"],
            batch_stats=variables["batch_stats"], tx=jax_make_optimizer(LR))
        self.jcrit = jax_get_loss("dice")(**LOSS)
        self.jstep = jax_train_step(self.jcrit)
        self.jeval = jax_eval_step(NC)

        self.model = net(in_channel=1, n_classes=NC, bias=True, BN=True,
                         dtype=torch.bfloat16 if bf16 else None)
        self.model.load_state_dict(unet_from_flax(numpy_tree(variables),
                                                  self.model))
        self.state = TrainState(self.model,
                                       make_optimizer(self.model, LR))
        self.step = make_seg_train_step(get_loss_function("dice")(**LOSS))
        self.eval = make_seg_eval_step(NC)

    def jax_grads(self, img, seg):
        """Gradients at the JAX state's current parameters (its train step
        returns none)."""
        state = self.jstate

        def loss_fn(params):
            logits, _ = _apply_model(state, params, jnp.asarray(img),
                                     train=True)
            return self.jcrit(logits.astype(jnp.float32),
                              jnp.asarray(seg.astype(np.int32)))

        return jax.grad(loss_fn)(state.params)

    def advance(self, img, seg):
        """One step in both packages; returns (jax loss, port loss, jax
        grads mapped onto the port's parameter names)."""
        grads = unet_from_flax({"params": numpy_tree(self.jax_grads(img, seg))},
                               self.model, params_only=True)
        # the JAX step donates its state: copy what is compared later
        self.jstate, jloss, _ = self.jstep(
            self.jstate, jnp.asarray(img), jnp.asarray(seg.astype(np.int32)))
        self.state, loss, logits = self.step(
            self.state, torch.from_numpy(img), torch.from_numpy(seg))
        assert logits.shape == VOL + (NC,) and not logits.requires_grad
        return float(jloss), float(loss), grads

    def follow_jax(self):
        """Move the port's state onto the JAX state: weights, BatchNorm
        statistics, Adam moments, count and learning rate."""
        sd, _, _ = self.jax_as_port()
        self.model.load_state_dict(sd)
        self.state.optimizer.load_state_dict(adam_from_optax(
            numpy_tree(self.jstate.opt_state), self.model))

    def jax_as_port(self):
        """The JAX state's parameters and BatchNorm statistics, and its Adam
        moments, under the port's names."""
        sd = unet_from_flax(numpy_tree({"params": self.jstate.params,
                                        "batch_stats":
                                            self.jstate.batch_stats}),
                            self.model)
        adam = numpy_tree(self.jstate.opt_state.inner_state[0])
        mu = unet_from_flax({"params": adam.mu}, self.model, params_only=True)
        nu = unet_from_flax({"params": adam.nu}, self.model, params_only=True)
        return sd, mu, nu


def rel_err(got, ref, floor=0.0):
    """max|got - ref| over max|ref|, after forgiving ``floor`` absolute."""
    got, ref = got.detach().float().numpy(), ref.float().numpy()
    err = max(np.abs(got - ref).max() - floor, 0.0)
    return err / max(np.abs(ref).max(), 1e-12)


def bias_before_batchnorm(name):
    return name.endswith(".bias") and ".bn." not in name \
        and not name.startswith("head.")


def check_param(name, p, ref, lr):
    """A parameter after one Adam step: every entry within 2 lr (where an
    entry's moment is rounding noise the sign of m / (sqrt(v) + eps) is the
    noise's, in either package), and within 2e-2 lr in the mean over
    entries -- except a bias in front of a BatchNorm, whose every entry is
    such noise."""
    err = (p.detach() - ref).abs()
    assert err.max().item() <= 2.0 * lr, f"param {name}"
    if not bias_before_batchnorm(name):
        assert err.mean().item() <= 2e-2 * lr, f"param {name}"


def mean_rel_err(got, ref):
    got, ref = got.detach().float().numpy(), ref.float().numpy()
    return np.abs(got - ref).mean() / max(np.abs(ref).max(), 1e-12)


def conditioning(model, criterion, img, seg):
    """Per parameter, how far a relative change of 1e-7 in the image (one
    float32 rounding) moves the gradients of ``model``: the floor under
    any comparison of float32 gradients at this state and batch."""
    def grads(image):
        model.zero_grad(set_to_none=True)
        criterion(model(torch.from_numpy(image), train=True).float(),
                  torch.from_numpy(seg)).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    base = grads(img)
    moved = grads((img * np.float32(1 + 1e-7)).astype(np.float32))
    return {n: float(rel_err(moved[n], base[n])) for n in base}


def check_states(pair, grads, steps_taken, lr, slack=None):
    """The port's state after a step it began from the JAX state, against
    the JAX state after the same step; ``slack`` is ``conditioning`` of
    that step."""
    sd, mu, nu = pair.jax_as_port()
    params = dict(pair.model.named_parameters())
    opt_state = pair.state.optimizer.state
    if pair.bf16:
        means = []
        for name, p in params.items():
            if bias_before_batchnorm(name) or name == "head.bias":
                continue
            assert rel_err(p.grad, grads[name]) <= 0.6, name
            means.append(mean_rel_err(p.grad, grads[name]))
            assert means[-1] <= 0.15, name
        assert np.mean(means) <= 0.06
        return
    for name, p in params.items():
        tol = max(2e-3, 3 * max(slack.values()))
        assert rel_err(p.grad, grads[name], 1e-7) <= tol, f"grad {name}"
        assert rel_err(opt_state[p]["exp_avg"], mu[name], 1e-7) <= tol, name
        assert rel_err(opt_state[p]["exp_avg_sq"], nu[name], 1e-14) \
            <= 2 * tol, name
        assert int(opt_state[p]["step"]) == steps_taken
        check_param(name, p, sd[name], lr)
    for name, buf in pair.model.named_buffers():
        assert rel_err(buf, sd[name]) <= 1e-4, f"batch_stats {name}"


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_one_and_three_train_steps_match_jax(rng, bf16):
    """Three steps with a learning-rate change after the first.  The
    compared port state starts every step from the JAX state (weights,
    BatchNorm statistics, Adam moments and count), so the second and third
    steps are held as tightly as the first; a second port state runs free
    from the common start and is held to what a chaotic trajectory allows
    (see ``check_free_run``)."""
    pair = Pair(rng, bf16, narrow=bf16)
    free_model = copy.deepcopy(pair.model)
    free = TrainState(free_model, make_optimizer(free_model, LR))
    loss_tol = 2e-2 if bf16 else 1e-5
    lr, lr_sum = LR, 0.0
    criterion = get_loss_function("dice")(**LOSS)
    for i, (img, seg) in enumerate(batches(rng, 3)):
        slack = None if bf16 else conditioning(copy.deepcopy(pair.model),
                                               criterion, img, seg)
        jloss, loss, grads = pair.advance(img, seg)
        free, free_loss, _ = pair.step(free, torch.from_numpy(img),
                                       torch.from_numpy(seg))
        lr_sum += lr
        assert abs(loss - jloss) <= loss_tol, (i, loss, jloss)
        assert abs(float(free_loss) - jloss) <= max(loss_tol, 1e-3)
        assert pair.state.step == free.step == i + 1 == int(pair.jstate.step)
        check_states(pair, grads, i + 1, lr, slack)
        pair.follow_jax()
        if i == 0:
            # the host changes the learning rate between steps
            lr = 2e-4
            pair.jstate = jax_set_lr(pair.jstate, lr)
            for state in (pair.state, free):
                set_learning_rate(state, lr)
    assert pair.state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)
    assert free.optimizer.param_groups[0]["lr"] == 2e-4
    check_free_run(pair, free_model, lr_sum)


def check_free_run(pair, free_model, lr_sum):
    """The port after three steps on its own against the JAX package after
    its three.  Where a gradient entry is rounding noise (about 1e-9),
    Adam's first update lr * g / (|g| + eps) takes the noise's sign in
    either package, and this net's gradients move by several percent when a
    handful of weights move by 2e-3 (measured), so the two runs drift apart
    from the second step on.  What holds: no parameter is further from its
    twin than both could have walked, and the BatchNorm statistics, which
    average activations, stay within 2%."""
    sd, _, _ = pair.jax_as_port()
    for name, p in free_model.named_parameters():
        err = (p.detach() - sd[name]).abs().max().item()
        assert err <= 2.5 * lr_sum, f"free-running param {name}: {err}"
    for name, buf in free_model.named_buffers():
        assert rel_err(buf, sd[name]) <= 2e-2, f"free-running {name}"


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_eval_step_dice_matches_jax(rng, bf16):
    pair = Pair(rng, bf16)
    (img, seg), = batches(rng, 1)
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    jdice, jlogits = pair.jeval(pair.jstate, jnp.asarray(img),
                                jnp.asarray(seg.astype(np.int32)))
    dice, logits = pair.eval(pair.state, torch.from_numpy(img),
                             torch.from_numpy(seg))
    assert dice.shape == (1, NC - 1) and not logits.requires_grad
    # argmax flips only where two logits tie within the logit tolerance
    np.testing.assert_allclose(dice.numpy(), np.asarray(jdice),
                               atol=5e-2 if bf16 else 2e-3)
    scale = np.abs(np.asarray(jlogits, dtype=np.float32)).max()
    err = np.abs(logits.float().numpy()
                 - np.asarray(jlogits, dtype=np.float32)).max()
    assert err <= (5e-2 if bf16 else 1e-4) * scale
    for k, v in pair.model.state_dict().items():    # eval changes nothing
        assert torch.equal(v, before[k]), k


def test_adam_from_optax_round_trip(rng):
    """Two JAX steps, then the optimizer state crosses with
    ``adam_from_optax`` (as optax's namedtuples and as the nested dicts a
    checkpoint restores) and both packages take a third step."""
    pair = Pair(rng, bf16=False)
    data = batches(rng, 3)
    for img, seg in data[:2]:
        pair.jstate, _, _ = pair.jstep(pair.jstate, jnp.asarray(img),
                                       jnp.asarray(seg.astype(np.int32)))
    pair.jstate = jax_set_lr(pair.jstate, 5e-4)
    sd, mu, nu = pair.jax_as_port()
    opt = numpy_tree(pair.jstate.opt_state)
    as_dicts = {"count": opt.count, "hyperparams": dict(opt.hyperparams),
                "hyperparams_states": {},
                "inner_state": [{"count": opt.inner_state[0].count,
                                 "mu": opt.inner_state[0].mu,
                                 "nu": opt.inner_state[0].nu}, None]}
    pair.model.load_state_dict(sd)
    for form in (opt, as_dicts):
        adam_sd = adam_from_optax(form, pair.model)
        assert adam_sd["param_groups"][0]["lr"] == pytest.approx(5e-4)
        for i, (name, _) in enumerate(pair.model.named_parameters()):
            assert float(adam_sd["state"][i]["step"]) == 2.0
            assert torch.equal(adam_sd["state"][i]["exp_avg"], mu[name])
            assert torch.equal(adam_sd["state"][i]["exp_avg_sq"], nu[name])
    pair.state.optimizer.load_state_dict(adam_sd)
    img, seg = data[2]
    jloss, loss, _ = pair.advance(img, seg)
    assert abs(loss - jloss) <= 1e-5
    sd, mu, _ = pair.jax_as_port()
    for name, p in pair.model.named_parameters():
        check_param(name, p, sd[name], 5e-4)
        assert int(pair.state.optimizer.state[p]["step"]) == 3
