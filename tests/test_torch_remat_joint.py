"""The joint DeepAtlas experiment with rematerialization, on the CPU: the
seg step's ``checkpoint_apply`` against the JAX step built with it in each
label regime (the regime's ``hard_fused`` branch against the JAX dense
path) and bit for bit against the port's step without it, remat blocks
nested under it too; the overflow guard's ``xla`` action, which turns
``checkpoint_seg_apply`` on; and the experiment built from the JAX remat
config keys, bit for bit against the same config without them.

Tolerances, those of ``tests/test_torch_joint_steps.py``: metrics 1e-5,
gradients 2e-3 of a tensor's largest entry plus 1e-7, statistics 1e-5.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

from deepatlas_tpu.losses import get_loss_function as jax_get_loss
from deepatlas_tpu.train.reg_steps import \
    make_joint_seg_step as jax_joint_seg_step
from deepatlas_torch import kernels
from deepatlas_torch.losses import get_loss_function
from deepatlas_torch.models import get_network, layers, unet_from_flax
from deepatlas_torch.train import (TrainState, make_joint_seg_step,
                                   make_optimizer, reg_steps)
from deepatlas_torch.train.deepatlas import DeepAtlasExperiment
from test_torch_joint_steps import (ANAT_W, MAX_DISP, NC, REGIMES, SUP,
                                    SUP_W, Setup, check_grads, numpy_tree)
from test_torch_remat import DEC, ENC, blocks, forwards, with_remat
from test_torch_train_deepatlas import corpus, tiny_config  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------- the joint seg step

@pytest.fixture(scope="module")
def joint():
    return Setup()


def jax_checkpointed_seg_result(setup, regime):
    def clamped_warp(v, g):
        from deepatlas_tpu import ops as jops
        return jops.grid_sample(v, jops.clamp_displacement(g, MAX_DISP),
                                mode="trilinear")

    step = jax_joint_seg_step(
        jax_get_loss("dice")(**SUP), ANAT_W, SUP_W, NC,
        warp_fn=clamped_warp, two_pass=True, hard_fused=False,
        checkpoint_apply=True)
    seg, reg = setup.jax_states()
    new, metrics = step(seg, reg, *setup.args(regime, "jax"))
    model = setup.port_seg()
    grads = unet_from_flax({"params": numpy_tree(new.opt_state)}, model,
                           params_only=True)
    stats = unet_from_flax({"params": numpy_tree(new.params),
                            "batch_stats": numpy_tree(new.batch_stats)},
                           model)
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def port_joint_seg(setup, regime, checkpoint_apply, remat=False):
    seg, reg = setup.port_states()
    if remat:
        model = with_remat(seg.model)
        seg = TrainState(model, make_optimizer(model, 1e-3))
    step = make_joint_seg_step(
        get_loss_function("dice")(**SUP), ANAT_W, SUP_W, NC,
        warp_fn=functools.partial(kernels.grid_sample, max_disp=MAX_DISP,
                                  grad="values"),
        checkpoint_apply=checkpoint_apply, hard_fused=True,
        max_disp=MAX_DISP)
    with forwards() as counts:
        seg, metrics = step(seg, reg, *setup.args(regime, "torch"))
    return (metrics, {k: p.grad.clone() for k, p in
                      seg.model.named_parameters()},
            seg.model.state_dict(), dict(counts), seg.model)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_joint_seg_step_checkpoint_apply_matches_jax(joint, regime):
    """``checkpoint_apply=True`` against the JAX step built with it (the
    regime's ``hard_fused`` branch against the JAX dense path), and against
    the port's own step without it, bit for bit, with remat blocks nested
    under it too; each differentiated apply runs its forward once more."""
    jm, jgrads, jstats = jax_checkpointed_seg_result(joint, regime)
    metrics, grads, state, counts, model = port_joint_seg(joint, regime,
                                                          True)
    m = {k: float(v) for k, v in metrics.items()}
    for key in jm:
        assert abs(m[key] - jm[key]) <= 1e-5, (key, m[key], jm[key])
    for name, p in model.named_parameters():
        p.grad = grads[name]
    check_grads(model, jgrads, regime)
    for name, buf in model.named_buffers():
        assert (buf - jstats[name]).abs().max().item() <= 1e-5, name
    plain = port_joint_seg(joint, regime, False)
    nested = port_joint_seg(joint, regime, True, remat=True)
    for other in (plain, nested):
        for k in metrics:
            assert torch.equal(metrics[k], other[0][k]), k
        for k in grads:
            assert torch.equal(grads[k], other[1][k]), k
        for k in state:
            assert torch.equal(state[k], other[2][k]), k
    # two differentiated applies a step (moving, then fixed), the frozen
    # reg net's forward (11 convs, 1 upsample) outside the checkpoints
    convs, deconvs = blocks(with_remat(model))
    extra = {"conv3d_k3": 2 * convs, "deconv2x": 2 * deconvs,
             "conv3d_point": 2}
    assert counts == {k: plain[3][k] + extra[k] for k in extra}
    assert nested[3] == {k: counts[k] + extra[k] - 2 * (k == "conv3d_point")
                         for k in extra}


def test_guard_xla_action_turns_on_checkpoint_seg_apply(corpus):  # noqa: F811
    """The guard's unclamped-warp action sets ``checkpoint_seg_apply`` where
    the config does not say (as the JAX guard does), and the rebuilt seg
    step recomputes each differentiated apply; a config's own False
    stands."""
    for given, want in ((None, True), (False, False)):
        config = tiny_config(corpus, max_disp=8)
        if given is not None:
            config["checkpoint_seg_apply"] = given
        exp = DeepAtlasExperiment(config)
        exp.setup_model()
        exp.setup_loss()
        exp._init_state()
        exp._apply_guard_action({"action": "xla"})
        assert exp.config["checkpoint_seg_apply"] is want
        assert exp.config["max_disp"] is None
        rng = np.random.RandomState(2)
        images = [torch.from_numpy(rng.rand(1, 16, 16, 16, 1).astype(
            np.float32)) for _ in range(2)]
        labels = [torch.from_numpy(rng.randint(0, 32, (1, 16, 16, 16)))
                  for _ in range(2)]
        flags = [torch.tensor([False]), torch.tensor([True])]
        with mock.patch.object(reg_steps, "checkpointed",
                               wraps=layers.checkpointed) as spy:
            exp.seg_step(exp.seg_state, exp.reg_state, *images, *labels,
                         *flags)
        assert spy.call_count == (2 if want else 0)


def test_the_experiments_train_with_the_remat_keys(corpus):  # noqa: F811
    """A JAX joint config with ``"remat": true`` in ``seg_model_settings``
    and ``reg_model_settings`` and ``checkpoint_seg_apply: true`` builds
    recomputing nets and steps, and one seg and one reg step of it equal
    the same steps without those keys bit for bit; ``remat`` in the seg
    and reg experiments' ``model_settings`` builds recomputing nets."""
    from deepatlas_torch.models import resolve_model_settings

    rng = np.random.RandomState(4)
    images = [torch.from_numpy(rng.rand(1, 16, 16, 16, 1).astype(
        np.float32)) for _ in range(2)]
    labels = [torch.from_numpy(rng.randint(0, 32, (1, 16, 16, 16)))
              for _ in range(2)]
    flags = [torch.tensor([False]), torch.tensor([True])]
    results = []
    for on in (False, True):
        config = tiny_config(corpus)
        for key in ("seg_model_settings", "reg_model_settings"):
            config[key] = dict(config[key], remat=on)
        config["checkpoint_seg_apply"] = on
        exp = DeepAtlasExperiment(config)
        torch.manual_seed(9)
        exp.setup_model()
        exp.setup_loss()
        exp._init_state()
        assert blocks(exp.seg_model) == ((14, 3) if on else (0, 0))
        assert blocks(exp.reg_model) == ((10, 0) if on else (0, 0))
        with forwards() as counts:
            _, seg_m = exp.seg_step(exp.seg_state, exp.reg_state, *images,
                                    *labels, *flags)
            _, reg_m = exp.reg_step(exp.reg_state, exp.seg_state, *images,
                                    *labels, *flags)
        results.append((seg_m, reg_m, {k: v.clone() for k, v in
                                       exp.seg_model.state_dict().items()},
                        {k: v.clone() for k, v in
                         exp.reg_model.state_dict().items()}, counts))
    plain, remat = results
    for a, b in zip(plain[:4], remat[:4]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert remat[4]["conv3d_k3"] > plain[4]["conv3d_k3"]
    # the seg and reg experiments build their net from model_settings as
    # the joint one does, through resolve_model_settings (JSON-borne keys)
    for name, settings in (("UNet", {"n_classes": 4, "dtype": "bfloat16"}),
                           ("voxel_morph_cvpr", {"enc_filters": ENC,
                                                 "dec_filters": DEC})):
        net = get_network(name)(**resolve_model_settings(
            dict(settings, remat=True)))
        assert blocks(net) == ((14, 3) if name == "UNet" else (10, 0))
