"""The frozen yardstick against hand sums."""
from __future__ import annotations

import json
import math
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH]

from yardstick import passes  # noqa: E402
from yardstick.work import bound_s, work  # noqa: E402


def load(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_unet_light_forward_per_voxel():
    """UNet_light's forward at 32 classes: 113,520 FLOPs a voxel, by level:
    2 * 27 * (1*8 + 8*16) at full size, (16*16 + 16*32) / 8,
    (32*32 + 32*64) / 64, (64*64 + 64*64) / 512; the deconvs 2 * 8 * Cin *
    Cout on the coarser side; the decoders' convs (128*64 + 64*64) / 64,
    (96*32 + 32*32) / 8, 48*16 + 16*16; the head 2 * 16 * 32."""
    c = load("deepatlas_mb101")
    k3 = 54 * (136 + 768 / 8 + 3072 / 64 + 8192 / 512
               + 12288 / 64 + 4096 / 8 + 1024)
    deconv = 16 * (64 * 64 / 512 + 64 * 64 / 64 + 32 * 32 / 8)
    assert k3 + deconv + 2 * 16 * 32 == 113520
    shape = passes.cropped_shape(c)
    assert shape == (168, 200, 168)
    layers = passes.unet_layers(c, shape)
    flops = sum(x.flops for x in passes.forward_calls(layers))
    assert flops == 113520 * math.prod(shape)


def test_training_pass_is_three_forwards_less_first_dx():
    c = load("deepatlas_mb101")
    shape = passes.cropped_shape(c)
    layers = passes.unet_layers(c, shape)
    fwd = sum(x.flops for x in passes.forward_calls(layers))
    first = layers[0]
    first_dx = 2 * 27 * first.cin * first.cout * first.n_out
    assert passes.model_flops(c, "seg") == 3 * fwd - first_dx


def test_joint_step_kinds():
    c = load("deepatlas_mb101")
    seg = passes.model_flops(c, "seg")
    shape = passes.cropped_shape(c)
    vm = passes.voxelmorph_layers(c, shape)
    vm_fwd = sum(x.flops for x in passes.forward_calls(vm) if x.model)
    unet_fwd = sum(x.flops for x in passes.forward_calls(
        passes.unet_layers(c, shape)))
    for regime in ("soft", "f_hard", "m_hard", "hard"):
        assert passes.model_flops(c, "joint_seg." + regime) == \
            pytest.approx(2 * seg + vm_fwd)
    assert passes.model_flops(c, "joint_reg.2") - \
        passes.model_flops(c, "joint_reg.0") == pytest.approx(2 * unet_fwd)
    # VoxelMorph's sizes: 168 200 168 halved four times, rounding up
    assert [ly.n_out for ly in vm[:5]] == [
        168 * 200 * 168, 84 * 100 * 84, 42 * 50 * 42, 21 * 25 * 21,
        11 * 13 * 11]


def test_serving_tiles_and_bounds():
    o = load("oai_unet_light")
    assert passes.serve_tiles(o) == 2 * 4 * 4
    # A's least time on one 4 x 128^3 tile batch: 1.079 ms (operations)
    per_batch = passes.kernel_bound_s(o, "serve", ["conv3d_k3"]) / 8
    assert per_batch * 1e3 == pytest.approx(1.079, abs=1e-3)
    c = load("deepatlas_mb101")
    assert passes.kernel_bound_s(c, "seg", ["conv3d_k3"]) * 1e3 == \
        pytest.approx(1.422, abs=1e-3)
    assert passes.kernel_bound_s(c, "seg", ["conv3d_k3_wgrad"]) * 1e3 == \
        pytest.approx(0.726, abs=1e-3)


def test_work_counts_each_byte_once():
    flops, nbytes = work("conv3d_k3", 1000, 8, 16, "bfloat16")
    assert flops == 2 * 27 * 8 * 16 * 1000
    assert nbytes == 1000 * 8 * 2 + 27 * 8 * 16 * 4 + 1000 * 16 * 2
    assert bound_s(989e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
