"""The joint DeepAtlas steps of deepatlas_torch against the JAX package's,
from the same weights and the same pair, in each label regime.

The JAX side runs ``make_joint_reg_step`` / ``make_joint_seg_step`` on the
reference's exact dense path (``fused_anatomy=False``,
``hard_fused=False``) with a clamping XLA warp, which the JAX package's own
tests pin equal to its fused branches (``tests/test_train_reg.py``).  The
port runs its fused branches -- the reg step's anatomy on the matched-label
kernels, the seg step's ``hard_fused`` table ``[soft, f_hard, m_hard,
hard]`` -- and also its dense paths and its single-graph seg step, all
against the same JAX step.  The JAX steps record their gradients in their
optimizer state (an optax transformation that keeps the gradient and
updates nothing), the port's are read from ``.grad`` after its step.

Tolerances.  float32 throughout (anatomy tensors included), the same
formulas summed in another order: losses to 1e-5; gradients to 2e-3 of each
tensor's largest entry plus 1e-7 absolute, except a conv bias in front of a
BatchNorm, which has no gradient (the batch mean removes it) and holds
rounding noise of up to about 2e-7 in either package: both are held below
1e-6; BatchNorm running statistics to 1e-5.  The port's branches and
its two pass settings agree with each other to the same tolerances.
"""
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu import ops as jops
from deepatlas_tpu.losses import get_loss_function as jax_get_loss
from deepatlas_tpu.models import UNetTemplate as JaxUNetTemplate
from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVoxelMorph
from deepatlas_tpu.train.reg_steps import (
    make_joint_reg_step as jax_joint_reg_step,
    make_joint_seg_step as jax_joint_seg_step)
from deepatlas_tpu.train.steps import TrainState as JaxTrainState
from deepatlas_torch import kernels
from deepatlas_torch.losses import get_loss_function
from deepatlas_torch.models import (UNetTemplate, VoxelMorphCVPR2018,
                                    unet_from_flax, voxelmorph_from_flax)
from deepatlas_torch.train import (TrainState, make_joint_reg_step,
                                   make_joint_seg_step, make_optimizer)

VOL = (1, 16, 16, 16)
NC = 4
PLAN = dict(encoders=((4, 8), (8, 8, 16)), decoders=((16, 8, 8),),
            act="LeakyReLU")
ENC, DEC = (4, 8, 8, 8, 8), (8, 8, 8, 4, 4)
MAX_DISP = 2
REG_W, ANAT_W, SUP_W = 0.5, 3.0, 1.0
SUP = {"n_class": NC, "weight_type": "Uniform", "no_bg": False,
       "softmax": True, "eps": 1e-6}
# (moving labelled, fixed labelled) -> the branch of the reference's table
REGIMES = {"soft": (False, False), "f_hard": (False, True),
           "m_hard": (True, False), "hard": (True, True)}


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


# keeps the gradient as its state and updates nothing
RECORD_GRADS = optax.GradientTransformation(
    init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    update=lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def randomize(variables, rng, flow_scale=1.0):
    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            if shape[-1] == 3:
                a = a * flow_scale
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1 + 0.2 * rng.randn(*shape)
        else:                                   # bias, BN bias, mean
            a = 0.2 * rng.randn(*shape)
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, variables)


class Setup:
    """Weights, a pair and the JAX steps, shared by the module's tests."""

    def __init__(self):
        rng = np.random.RandomState(230)
        self.jseg = JaxUNetTemplate(**PLAN, in_channel=1, n_classes=NC,
                                    bias=True, BN=True)
        self.jreg = JaxVoxelMorph(enc_filters=ENC, dec_filters=DEC)
        x0 = jnp.zeros(VOL + (1,), jnp.float32)
        self.seg_vars = numpy_tree(randomize(dict(jax.jit(
            self.jseg.init, static_argnames="train")(
                jax.random.PRNGKey(0), x0, train=False)), rng))
        self.reg_vars = numpy_tree(randomize(dict(jax.jit(self.jreg.init)(
            jax.random.PRNGKey(1), x0, x0)), rng, flow_scale=0.3))
        zz, yy, xx = np.meshgrid(*[np.arange(s) for s in VOL[1:]],
                                 indexing="ij")
        blocks = ((zz // 8) * 2 + (yy // 8)) % NC
        fixed = 0.5 + 0.25 * (np.sin(0.9 * zz) * np.cos(0.7 * yy)
                              + np.sin(0.8 * xx)) + 0.1 * blocks
        moving = np.roll(fixed, 1, axis=2) * 0.9 + 0.05 * rng.rand(*VOL[1:])
        # noise keeps the two top values of a max-pool window apart by more
        # than the two packages' rounding: a smooth image has near-ties
        # whose gradient either package may route to the other voxel
        fixed = fixed + 0.2 * rng.rand(*VOL[1:])
        self.moving = moving.astype(np.float32)[None, ..., None]
        self.fixed = fixed.astype(np.float32)[None, ..., None]
        self.mseg = np.roll(blocks, 1, axis=2)[None].astype(np.int32)
        self.fseg = blocks[None].astype(np.int32)

        def clamped_warp(v, g):
            return jops.grid_sample(v, jops.clamp_displacement(g, MAX_DISP),
                                    mode="trilinear")

        self.jreg_step = jax_joint_reg_step(
            jax_get_loss("lncc")(filter_size=5),
            jax_get_loss("bendingEnergy")(),
            REG_W, ANAT_W, NC, warp_fn=clamped_warp, max_disp=MAX_DISP,
            fused_anatomy=False)
        self.jseg_step = jax_joint_seg_step(
            jax_get_loss("dice")(**SUP), ANAT_W, SUP_W, NC,
            warp_fn=clamped_warp, two_pass=True, hard_fused=False)
        self.results = {}

    def jax_states(self):
        copy = functools.partial(jax.tree_util.tree_map, jnp.asarray)
        seg = JaxTrainState.create(
            apply_fn=self.jseg.apply, params=copy(self.seg_vars["params"]),
            batch_stats=copy(self.seg_vars["batch_stats"]), tx=RECORD_GRADS)
        reg = JaxTrainState.create(
            apply_fn=self.jreg.apply, params=copy(self.reg_vars["params"]),
            batch_stats={}, tx=RECORD_GRADS)
        return seg, reg

    def args(self, regime, framework):
        has_m, has_f = REGIMES[regime]
        arrays = (self.moving, self.fixed, self.mseg, self.fseg)
        flags = (np.array([has_m]), np.array([has_f]))
        if framework == "jax":
            return tuple(jnp.asarray(a) for a in arrays + flags)
        return tuple(torch.from_numpy(np.array(a)) for a in arrays + flags)

    def jax_result(self, phase, regime):
        """(metrics, gradients as the port's state_dict names, new seg
        state_dict) of one JAX step, computed once per phase and regime."""
        key = (phase, regime)
        if key not in self.results:
            seg, reg = self.jax_states()
            if phase == "seg":
                new, metrics = self.jseg_step(seg, reg,
                                              *self.args(regime, "jax"))
                model = self.port_seg()
                grads = unet_from_flax({"params": numpy_tree(new.opt_state)},
                                       model, params_only=True)
                stats = unet_from_flax(
                    {"params": numpy_tree(new.params),
                     "batch_stats": numpy_tree(new.batch_stats)}, model)
            else:
                new, metrics = self.jreg_step(reg, seg,
                                              *self.args(regime, "jax"))
                grads = voxelmorph_from_flax(
                    {"params": numpy_tree(new.opt_state)}, self.port_reg())
                stats = None
            self.results[key] = ({k: float(v) for k, v in metrics.items()},
                                 grads, stats)
        return self.results[key]

    def port_seg(self):
        model = UNetTemplate(**PLAN, in_channel=1, n_classes=NC, bias=True,
                             BN=True)
        model.load_state_dict(unet_from_flax(self.seg_vars, model))
        return model

    def port_reg(self):
        model = VoxelMorphCVPR2018(enc_filters=ENC, dec_filters=DEC,
                                   max_disp=None)
        model.load_state_dict(voxelmorph_from_flax(self.reg_vars, model))
        return model

    def port_states(self):
        seg, reg = self.port_seg(), self.port_reg()
        return (TrainState(seg, make_optimizer(seg, 1e-3)),
                TrainState(reg, make_optimizer(reg, 1e-3)))


@pytest.fixture(scope="module")
def setup():
    return Setup()


def check_grads(model, grads, what):
    # a conv bias in front of a BatchNorm: the batch mean removes it
    noise_only = {f"{name}.bias" for name, mod in model.named_modules()
                  if getattr(mod, "bn", None) is not None}
    for name, p in model.named_parameters():
        ref = grads[name]
        if name in noise_only:
            assert p.grad.abs().max().item() <= 1e-6, (what, name)
            assert ref.abs().max().item() <= 1e-6, (what, name)
            continue
        err = (p.grad - ref).abs().max().item()
        assert err <= 2e-3 * ref.abs().max().item() + 1e-7, (what, name, err)


def port_seg_step(setup, regime, variant):
    seg, reg = setup.port_states()
    step = make_joint_seg_step(
        get_loss_function("dice")(**SUP), ANAT_W, SUP_W, NC,
        warp_fn=functools.partial(kernels.grid_sample, max_disp=MAX_DISP,
                                  grad="values"),
        two_pass=variant != "single_graph",
        hard_fused=variant == "hard_fused", max_disp=MAX_DISP)
    before = {k: v.clone() for k, v in reg.model.state_dict().items()}
    seg, metrics = step(seg, reg, *setup.args(regime, "torch"))
    assert seg.step == 1
    for k, v in reg.model.state_dict().items():     # the reg net is frozen
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in reg.model.parameters())
    return seg, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("variant", ["hard_fused", "soft", "single_graph"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_joint_seg_step_matches_jax(setup, regime, variant):
    """Loss, anatomy, supervised, gradients and BatchNorm running statistics
    ("moving, then fixed") of one seg step; ``hard_fused`` takes the
    regime's branch, ``soft`` the general two-pass path, ``single_graph``
    one backward."""
    jm, jgrads, jstats = setup.jax_result("seg", regime)
    seg, m = port_seg_step(setup, regime, variant)
    assert set(m) == set(jm) == {"loss", "anatomy", "supervised"}
    for key in m:
        assert abs(m[key] - jm[key]) <= 1e-5, (key, m[key], jm[key])
    assert abs(m["loss"] - (ANAT_W * m["anatomy"]
                            + SUP_W * m["supervised"])) <= 1e-5
    check_grads(seg.model, jgrads, (regime, variant))
    for name, buf in seg.model.named_buffers():
        err = (buf - jstats[name]).abs().max().item()
        assert err <= 1e-5, (name, err)
    if regime == "hard":
        # both anatomies are constants: the anatomy moves no seg weight
        assert 0.0 < m["anatomy"] < 1.0


def test_joint_seg_step_rejects_what_is_not_ported(setup):
    sup = get_loss_function("dice")(**SUP)
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        make_joint_seg_step(sup, ANAT_W, SUP_W, NC, checkpoint_apply=True)
    with pytest.raises(ValueError, match="max_disp"):
        make_joint_seg_step(sup, ANAT_W, SUP_W, NC, hard_fused=True)
    with pytest.raises(ValueError, match="max_disp"):
        make_joint_reg_step(None, None, REG_W, ANAT_W, NC,
                            fused_anatomy=True)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_joint_reg_step_matches_jax(setup, regime, fused):
    """Loss terms, ``disp_overflow`` and the reg net's gradients of one reg
    step; unlabelled sides take the frozen seg net's prediction (eval-mode
    BatchNorm), which gets no gradient and keeps its statistics."""
    jm, jgrads, _ = setup.jax_result("reg", regime)
    seg, reg = setup.port_states()
    step = make_joint_reg_step(
        get_loss_function("lncc")(filter_size=5),
        get_loss_function("bendingEnergy")(), REG_W, ANAT_W, NC,
        warp_fn=functools.partial(kernels.grid_sample, max_disp=MAX_DISP),
        max_disp=MAX_DISP, fused_anatomy=fused)
    before = {k: v.clone() for k, v in seg.model.state_dict().items()}
    reg, metrics = step(reg, seg, *setup.args(regime, "torch"))
    m = {k: float(v) for k, v in metrics.items()}
    assert set(m) == set(jm) == {"loss", "sim", "reg", "anatomy",
                                 "disp_overflow"}
    for key in m:
        assert abs(m[key] - jm[key]) <= 1e-5, (key, m[key], jm[key])
    assert 0.0 < m["disp_overflow"] < 1.0       # the clamp is in play
    check_grads(reg.model, jgrads, (regime, fused))
    for k, v in seg.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in seg.model.parameters())
