"""The port's joint reg step against the benchmark's plain reference on a
zero-background brain pair, at the weights the benchmark draws.

``benchmark/reference/steps.joint_reg_step`` (plain PyTorch: ``grid_sample``
warps, ``avg_pool3d`` window sums) is imported by path, as the benchmark's
tests do.  Both sides take the same drawn weights, the VoxelMorph flow head
at its published N(0, 1e-5): a near-identity warp that leaks a hundred-
thousandth of the brain's edge into its zero background, the case where
LNCC's window sums must keep their digits.  One step with both sides
labelled and one with the fixed side's labels from the frozen seg net,
float32 on the CPU.  (With the moving side substituted too, the frozen
net's argmax at drawn weights has near-ties that two float32 forwards
break differently: other labels, not rounding.)

Tolerances: the loss within 1e-5 of the reference's, relative (float32
rounding of the LNCC mean, the bending energy and the dice sums in another
order; 1.4e-7 to 3.9e-7 read).  The reg net's first gradient, leaf by
leaf, within 3e-2 of the larger of that leaf's largest entry and the
median leaf's, and the median leaf within 1e-2: LNCC's part alone agrees
to 2e-4, but at a field of 1e-5 voxels every sample lies next to a grid
point, where the trilinear warp's derivative is one-sided; the port's
matched-label anatomy (``fused_anatomy``) and the reference's
``grid_sample`` of one-hots round the sample's position on either side of
it at some label boundaries (worst leaf 1.4e-2, median 6.1e-3 read).
"""
import json
import os
import sys
from functools import partial

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import corpus  # noqa: E402
import weights  # noqa: E402
from reference import nets  # noqa: E402
from reference import steps as ref_steps  # noqa: E402
from reference.precision import Precision  # noqa: E402

from deepatlas_torch.kernels import grid_sample  # noqa: E402
from deepatlas_torch.losses import get_loss_function  # noqa: E402
from deepatlas_torch.models import get_network  # noqa: E402
from deepatlas_torch.train.reg_steps import make_joint_reg_step  # noqa: E402
from deepatlas_torch.train.steps import (TrainState,  # noqa: E402
                                         make_optimizer)

SHAPE = (24, 32, 24)
LOSS_TOL, GRAD_TOL, MEDIAN_TOL = 1e-5, 3e-2, 1e-2


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(BENCH, "configs",
                           "deepatlas_joint_mb101.json")) as f:
        return json.load(f)


def leaf_gaps(got, want):
    """Each leaf's largest difference over the larger of its own largest
    entry and the median leaf's."""
    tops = {k: float(v.abs().max()) for k, v in want.items()}
    med = sorted(tops.values())[len(tops) // 2]
    return {k: float((got[k] - want[k]).abs().max()) / max(tops[k], med)
            for k in want}


@pytest.mark.parametrize("has_m,has_f", [(True, True), (True, False)])
def test_joint_reg_step_matches_the_reference_on_a_zero_background(
        config, has_m, has_f):
    torch.manual_seed(0)
    c = config["n_classes"]
    vols = [corpus.mindboggle_volume(11, v, SHAPE, c) for v in range(2)]
    assert all((img[0] == 0).all() for img, _ in vols)  # a zero border
    x = torch.from_numpy(np.stack([np.clip(i, 0, 1) for i, _ in vols]))
    y = torch.from_numpy(np.stack([s for _, s in vols]).astype(np.int64))
    us, vs = nets.unet_spec(config), nets.voxelmorph_spec(config)
    wu = weights.make_weights(us, 12, "cpu")
    wv = weights.make_weights(vs, 13, "cpu")
    seg = get_network("UNet_light")(in_channel=1, n_classes=c, bias=True,
                                    BN=True)
    seg.load_state_dict(wu)
    reg = get_network("voxel_morph_cvpr")(
        enc_filters=config["reg_enc"], dec_filters=config["reg_dec"],
        max_disp=config["max_disp"])
    reg.load_state_dict(wv)
    lr = config["learning_rate"]
    seg_state = TrainState(seg, make_optimizer(seg, lr))
    reg_state = TrainState(reg, make_optimizer(reg, lr))
    step = make_joint_reg_step(
        get_loss_function("lncc")(filter_size=config["lncc_window"]),
        get_loss_function("bendingEnergy")(), config["reg_weight"],
        config["anatomy_weight"], c,
        warp_fn=partial(grid_sample, max_disp=config["max_disp"]),
        max_disp=config["max_disp"], fused_anatomy=True)
    xs = x[..., None]
    _, m = step(reg_state, seg_state, xs[:1], xs[1:], y[:1], y[1:],
                torch.tensor([has_m]), torch.tensor([has_f]))
    ref_seg = ref_steps.Net(wu, us, lr)
    ref_reg = ref_steps.Net(wv, vs, lr)
    ref_loss = ref_steps.joint_reg_step(
        config, ref_reg, ref_seg, x[:1, None], x[1:, None], y[:1], y[1:],
        has_m, has_f, Precision("float32"))
    assert abs(float(m["loss"]) - ref_loss) <= LOSS_TOL * abs(ref_loss)
    got = {k: reg_state.optimizer.state[p]["exp_avg"] / 0.1
           for k, p in reg.named_parameters()}
    gaps = leaf_gaps(got, ref_reg.opt.first_grads)
    assert max(gaps.values()) <= GRAD_TOL, \
        sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    assert sorted(gaps.values())[len(gaps) // 2] <= MEDIAN_TOL
