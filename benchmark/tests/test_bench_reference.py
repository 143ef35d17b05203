"""The plain reference against the port at tiny shapes on the CPU, both in
float32: one training step of each kind, the tiled serving and the NIfTI
reader and writer.  Run with ``python -m pytest benchmark/tests``."""
from __future__ import annotations

import json
import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import corpus  # noqa: E402
import weights  # noqa: E402
from reference import nets, ops, tiling  # noqa: E402
from reference import nifti as ref_nifti  # noqa: E402
from reference import steps as ref_steps  # noqa: E402
from reference.precision import Precision  # noqa: E402

SHAPE = (16, 16, 16)
F32 = Precision("float32")


def load_config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def mb():
    return load_config("deepatlas_mb101")


def volumes(seed, n=2, classes=32):
    out = [corpus.mindboggle_volume(seed, v, SHAPE, classes)
           for v in range(n)]
    x = torch.from_numpy(np.stack([np.clip(i, 0, 1) for i, _ in out]))
    y = torch.from_numpy(np.stack([s for _, s in out]).astype(np.int64))
    return x, y


def port_unet(config, w):
    from deepatlas_torch.models import get_network
    m = get_network("UNet_light")(in_channel=1, n_classes=config["n_classes"],
                                  bias=True, BN=True)
    m.load_state_dict(w)
    return m


def port_voxelmorph(config, w):
    from deepatlas_torch.models import get_network
    m = get_network("voxel_morph_cvpr")(enc_filters=config["reg_enc"],
                                        dec_filters=config["reg_dec"],
                                        max_disp=config["max_disp"])
    m.load_state_dict(w)
    return m


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def assert_close_leaves(got, want, tol):
    """Each leaf's largest difference within ``tol`` of the larger of its
    own largest entry and the median leaf's (a conv bias under BatchNorm
    has a gradient of rounding noise only)."""
    tops = {k: float(v.detach().abs().max()) for k, v in want.items()}
    med = sorted(tops.values())[len(tops) // 2]
    for k in want:
        err = float((got[k] - want[k]).abs().max()) / max(tops[k], med)
        assert err < tol, (k, err)


def test_seg_step(mb):
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.train.steps import (TrainState, make_optimizer,
                                             make_seg_train_step)
    spec = nets.unet_spec(mb)
    w = weights.make_weights(spec, 3, "cpu")
    x, y = volumes(1, n=1)
    model = port_unet(mb, w)
    state = TrainState(model, make_optimizer(model, 1e-3))
    crit = get_loss_function("dice")(n_class=32, weight_type="Uniform",
                                     softmax=True, eps=1e-6)
    step = make_seg_train_step(crit)
    state, loss, _ = step(state, x[..., None], y)
    net = ref_steps.Net(w, spec, 1e-3)
    ref_loss = ref_steps.seg_step(mb, net, x[:, None], y, F32)
    assert abs(float(loss) - ref_loss) < 1e-5
    got_g = {k: state.optimizer.state[p]["exp_avg"] / 0.1
             for k, p in model.named_parameters()}
    assert_close_leaves(got_g, net.opt.first_grads, 1e-3)
    # the parameters after Adam's first step, on the leaves whose reference
    # gradient is more than rounding (Adam moves the others by its sign)
    norms = ref_steps.leaf_norms(net.opt.first_grads)
    med = sorted(norms.values())[len(norms) // 2]
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    got = dict(model.named_parameters())
    assert_close_leaves({k: got[k] for k in keep},
                        {k: net.params[k] for k in keep}, 1e-2)


@pytest.mark.parametrize("has_m,has_f", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_joint_seg_step(mb, has_m, has_f):
    from deepatlas_torch.kernels import grid_sample
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.train.reg_steps import make_joint_seg_step
    from deepatlas_torch.train.steps import TrainState, make_optimizer
    us, vs = nets.unet_spec(mb), nets.voxelmorph_spec(mb)
    wu, wv = weights.make_weights(us, 4, "cpu"), \
        weights.make_weights(vs, 5, "cpu")
    wv["head.weight"] = wv["head.weight"] * 1e3   # a field that moves
    x, y = volumes(2)
    seg, reg = port_unet(mb, wu), port_voxelmorph(mb, wv)
    seg_state = TrainState(seg, make_optimizer(seg, 1e-3))
    reg_state = TrainState(reg, make_optimizer(reg, 1e-3))
    crit = get_loss_function("dice")(n_class=32, weight_type="Uniform",
                                     softmax=True, eps=1e-6)
    step = make_joint_seg_step(
        crit, 3.0, 1.0, 32, warp_fn=partial(grid_sample, max_disp=8,
                                            grad="values"),
        hard_fused=True, max_disp=8)
    xs = x[..., None]
    _, m = step(seg_state, reg_state, xs[:1], xs[1:], y[:1], y[1:],
                torch.tensor([has_m]), torch.tensor([has_f]))
    ref_seg = ref_steps.Net(wu, us, 1e-3)
    ref_reg = ref_steps.Net(wv, vs, 1e-3)
    ref_loss = ref_steps.joint_seg_step(mb, ref_seg, ref_reg, x[:1, None],
                                        x[1:, None], y[:1], y[1:], has_m,
                                        has_f, F32)
    assert abs(float(m["loss"]) - ref_loss) < 1e-4 * max(1, abs(ref_loss))
    got_g = {k: seg_state.optimizer.state[p]["exp_avg"] / 0.1
             for k, p in seg.named_parameters()}
    assert_close_leaves(got_g, ref_seg.opt.first_grads, 5e-3)


@pytest.mark.parametrize("has_m,has_f", [(True, True), (True, False),
                                         (False, False)])
def test_joint_reg_step(mb, has_m, has_f):
    from deepatlas_torch.kernels import grid_sample
    from deepatlas_torch.losses import get_loss_function
    from deepatlas_torch.train.reg_steps import make_joint_reg_step
    from deepatlas_torch.train.steps import TrainState, make_optimizer
    us, vs = nets.unet_spec(mb), nets.voxelmorph_spec(mb)
    wu, wv = weights.make_weights(us, 6, "cpu"), \
        weights.make_weights(vs, 7, "cpu")
    wv["head.weight"] = wv["head.weight"] * 1e3
    x, y = volumes(3)
    seg, reg = port_unet(mb, wu), port_voxelmorph(mb, wv)
    seg_state = TrainState(seg, make_optimizer(seg, 1e-3))
    reg_state = TrainState(reg, make_optimizer(reg, 1e-3))
    step = make_joint_reg_step(
        get_loss_function("lncc")(filter_size=9),
        get_loss_function("bendingEnergy")(), 1.0, 3.0, 32,
        warp_fn=partial(grid_sample, max_disp=8), max_disp=8,
        fused_anatomy=True)
    xs = x[..., None]
    _, m = step(reg_state, seg_state, xs[:1], xs[1:], y[:1], y[1:],
                torch.tensor([has_m]), torch.tensor([has_f]))
    ref_seg = ref_steps.Net(wu, us, 1e-3)
    ref_reg = ref_steps.Net(wv, vs, 1e-3)
    ref_loss = ref_steps.joint_reg_step(mb, ref_reg, ref_seg, x[:1, None],
                                        x[1:, None], y[:1], y[1:], has_m,
                                        has_f, F32)
    assert abs(float(m["loss"]) - ref_loss) < 1e-4 * max(1, abs(ref_loss))
    got_g = {k: reg_state.optimizer.state[p]["exp_avg"] / 0.1
             for k, p in reg.named_parameters()}
    assert_close_leaves(got_g, ref_reg.opt.first_grads, 5e-3)


def test_tiled_serving():
    from deepatlas_torch.train import (make_tile_predictor,
                                       sliding_window_predict)
    cfg = dict(load_config("oai_unet_light"), tile=[16, 16, 16],
               overlap=[2, 2, 2])
    spec = nets.unet_spec(cfg)
    w = weights.make_weights(spec, 8, "cpu", serving=True)
    img, _ = corpus.oai_volume(9, 0, (20, 40, 36), 5)
    img = np.clip(img, 0, 1)
    model = port_unet(cfg, w).eval()
    pred = sliding_window_predict(make_tile_predictor(model, 4),
                                  {"image": img[..., None]}, cfg["tile"],
                                  cfg["overlap"])
    stats = {k: v for k, v in w.items()
             if k.endswith(("running_mean", "running_var"))}
    logits = tiling.stitched_logits(cfg, w, stats, img, "cpu", F32, 4)
    assert pred.shape == img.shape
    assert tiling.label_gap(logits, torch.from_numpy(pred)) < 1e-4
    wrong = (pred + 1) % 5
    assert tiling.label_gap(logits, torch.from_numpy(wrong)) > 1e-2


def test_dice_matches_port():
    from deepatlas_torch.train import volume_dice
    rng = np.random.default_rng(0)
    a = rng.integers(0, 5, (10, 12, 14)).astype(np.uint8)
    b = rng.integers(0, 5, (10, 12, 14)).astype(np.uint8)
    np.testing.assert_allclose(volume_dice(a, b, 5, torch.device("cpu")),
                               tiling.dice(a, b, 5), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_nifti_round_trip(tmp_path, dtype):
    from deepatlas_torch.data import read_nifti, write_nifti
    rng = np.random.default_rng(1)
    data = (rng.random((5, 6, 7)) * 9).astype(dtype)
    ours = str(tmp_path / "ours.nii.gz")
    corpus.write_nifti(ours, data)
    np.testing.assert_array_equal(read_nifti(ours).data.astype(dtype), data)
    np.testing.assert_array_equal(ref_nifti.read(ours), data)
    theirs = str(tmp_path / "theirs.nii.gz")
    write_nifti(theirs, data)
    np.testing.assert_array_equal(ref_nifti.read(theirs), data)


def test_lncc_and_bending_match_port():
    from deepatlas_torch.losses import get_loss_function
    g = torch.Generator().manual_seed(0)
    a = torch.rand(1, 12, 13, 14, 1, generator=g)
    b = torch.rand(1, 12, 13, 14, 1, generator=g)
    f = torch.randn(1, 12, 13, 14, 3, generator=g) * 0.1
    port = get_loss_function("lncc")(filter_size=9)(a, b)
    ref = ops.lncc_loss(a.permute(0, 4, 1, 2, 3), b.permute(0, 4, 1, 2, 3))
    assert abs(float(port) - float(ref)) < 1e-4
    port = get_loss_function("bendingEnergy")()(f)
    assert abs(float(port) - float(ops.bending_energy(f))) < 1e-6
