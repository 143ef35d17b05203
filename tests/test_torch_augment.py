"""The device augmenter (``deepatlas_torch/data/augment.py``) against the
JAX package's ``deepatlas_tpu/data/augment.py``, on the CPU.

The port draws from torch generators, the JAX package from its keys, so the
deterministic parts are held against JAX on JAX's own draws: each test
reproduces them with the ``jax.random.split`` / ``normal`` / ``uniform``
calls ``augment.py`` makes and feeds them to the port's function of the
draw.  The port's own draws are held to their distributions.  Tolerances:
basis weights and B-spline fields atol 1e-6 (float32, summation order);
rigid grids atol 1e-6 (cos / sin and the 3x3 products may round one ulp
apart); warped images atol 1e-5 (the plain trilinear warp against XLA's);
blur atol 1e-6; warped labels on the same grid exact.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.data import augment as jaug
from deepatlas_tpu.ops import identity_grid as jax_identity_grid
from deepatlas_torch import kernels
from deepatlas_torch.data import augment as taug

FIELD_ATOL = 1e-6
GRID_ATOL = 1e-6
IMAGE_ATOL = 1e-5
BLUR_ATOL = 1e-6
# a non-cubic volume: the rigid rotation acts on normalized coordinates,
# anisotropic in voxels there, in both packages
SHAPE = (10, 14, 12)
CONFIG = {"bspline": {"mesh_size": [3, 3, 3], "deform_scale": 2.0,
                      "ratio": 0.5},
          "rigid": {"rotation_angles": [5, 5, 5], "translation": [2, 2, 2],
                    "ratio": 0.5, "mode": "both"},
          "blur": {"sigma": 0.7, "ratio": 0.3}}


def volumes(seed, batch=1, shape=SHAPE, channels=1):
    rng = np.random.RandomState(seed)
    image = rng.rand(batch, *shape, channels).astype(np.float32)
    seg = rng.randint(0, 4, (batch, *shape)).astype(np.int32)
    return image, seg


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ B-spline, by hand

@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("size,cells", [(1, 3), (7, 3), (24, 4), (19, 1)])
def test_bspline_axis_weights_match_jax(order, size, cells):
    got = taug._bspline_axis_weights(size, cells, order).numpy()
    want = np.asarray(jaug._bspline_axis_weights(size, cells, order))
    assert got.shape == want.shape == (size, cells + order)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_ATOL)
    if size > 1:
        # partition of unity at every voxel (ITK's layout)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_bspline_order_is_checked():
    with pytest.raises(ValueError, match="order must be 1, 2 or 3"):
        taug._bspline_basis(torch.zeros(3), 4)
    with pytest.raises(ValueError, match="random_mode"):
        taug.draw_bspline(torch.Generator(), random_mode="Gamma")


def jax_ctrl(key, mesh, order, scale, mode, freeze):
    """The control points ``random_bspline_field`` draws from ``key``."""
    cpts = tuple(m + order for m in mesh) + (3,)
    if mode == "Normal":
        ctrl = jax.random.normal(key, cpts) * (scale / 2.0)
    else:
        ctrl = jax.random.uniform(key, cpts) * scale
    for axis in freeze:
        ctrl = ctrl.at[..., axis].set(0.0)
    return np.asarray(ctrl)


@pytest.mark.parametrize("order,mode,freeze,mesh", [
    (2, "Normal", (), (3, 3, 3)),
    (1, "Normal", (2,), (2, 3, 4)),
    (3, "Uniform", (0, 1), (3, 2, 3)),
    (2, "Uniform", (), (1, 1, 1)),
])
def test_bspline_field_from_jax_control_points(order, mode, freeze, mesh):
    key = jax.random.PRNGKey(11 + order)
    want = np.asarray(jaug.random_bspline_field(
        key, SHAPE, mesh, 2.0, freeze, order, mode))
    ctrl = jax_ctrl(key, mesh, order, 2.0, mode, freeze)
    got = taug.bspline_field_from_ctrl(t(ctrl), SHAPE, mesh, order).numpy()
    assert got.shape == want.shape == SHAPE + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_ATOL)
    for axis in freeze:
        assert not got[..., axis].any()
    # batched: one field per control grid
    both = taug.bspline_field_from_ctrl(t(np.stack([ctrl, -ctrl])), SHAPE,
                                        mesh, order).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_allclose(both[1], -got, rtol=0, atol=FIELD_ATOL)


def test_port_draws_freeze_axes_and_the_field_function():
    gen = taug.key_generator((3, 1))
    ctrl, _ = taug.draw_bspline(gen, (3, 3, 3), 2.0, 0.5, (0, 2), 2,
                                "Normal")
    assert ctrl.shape == (5, 5, 5, 3) and ctrl.dtype == torch.float32
    assert not ctrl[..., 0].any() and not ctrl[..., 2].any()
    assert ctrl[..., 1].abs().min() > 0
    field = taug.random_bspline_field(taug.key_generator((3, 1)), SHAPE,
                                      (3, 3, 3), 2.0, (0, 2), 2, "Normal")
    torch.testing.assert_close(
        field, taug.bspline_field_from_ctrl(ctrl, SHAPE, (3, 3, 3), 2),
        rtol=0, atol=0)


@pytest.mark.parametrize("seed", range(6))
def test_bspline_warp_from_jax_draws(seed):
    """``random_bspline_warp`` of one element on JAX's draws: the image
    through the port's plain trilinear warp, the labels by nearest
    neighbour on the same grid."""
    mesh, order, scale, ratio = (3, 3, 3), 2, 2.0, 0.5
    image, seg = volumes(seed)
    key = jax.random.PRNGKey(seed)
    want_img, want_seg = jaug.random_bspline_warp(
        key, jnp.asarray(image[0]), jnp.asarray(seg[0]), mesh, scale, ratio,
        (), order, "Normal")
    k_apply, k_field = jax.random.split(key)
    ctrl = jax_ctrl(k_field, mesh, order, scale, "Normal", ())
    apply = bool(jax.random.uniform(k_apply) < ratio)
    deform = taug.bspline_deform(t(ctrl)[None], torch.tensor([apply]),
                                 SHAPE, mesh, order)
    got_img, got_seg = taug._warp_pair(t(image), t(seg), deform)
    np.testing.assert_allclose(got_img[0].numpy(), np.asarray(want_img),
                               rtol=0, atol=IMAGE_ATOL)
    # the same labels where the two grids agree to the bit; the JAX
    # package's own grid through the port's nearest warp, exactly
    jdeform = np.asarray(jaug.random_bspline_field(
        k_field, SHAPE, mesh, scale, (), order, "Normal")) * apply \
        + np.asarray(jax_identity_grid(SHAPE))
    _, seg_on_jax_grid = taug._warp_pair(t(image), t(seg),
                                         t(jdeform.astype(np.float32))[None])
    np.testing.assert_array_equal(seg_on_jax_grid[0].numpy(),
                                  np.asarray(want_seg))
    flips = (got_seg[0].numpy() != np.asarray(want_seg)).mean()
    assert flips <= 1e-3, flips
    if not apply:
        np.testing.assert_allclose(got_img[0].numpy(), image[0], rtol=0,
                                   atol=IMAGE_ATOL)
        np.testing.assert_array_equal(got_seg[0].numpy(), seg[0])


# --------------------------------------------------------- rigid, by hand

def jax_rigid_draws(key, angles, translation, ratio):
    """The draws ``random_rigid_warp`` makes from ``key``."""
    keys = jax.random.split(key, 3)
    rad = jax.random.normal(keys[0], (3,)) \
        * (jnp.asarray(angles) / 2.0) * (jnp.pi / 180.0)
    trans = jax.random.normal(keys[1], (3,)) \
        * (jnp.asarray(translation, dtype=jnp.float32) / 2.0)
    apply = bool(jax.random.uniform(keys[2]) < ratio)
    return np.asarray(rad, np.float32), np.asarray(trans, np.float32), apply


def jax_rigid_grid(rad, trans, shape):
    """``random_rigid_warp``'s grid (augment.py's four lines) on JAX."""
    d, h, w = shape
    rot = jaug._euler_matrix(*jnp.asarray(rad))
    grid = jax_identity_grid((d, h, w))
    half = jnp.asarray([(w - 1) / 2.0, (h - 1) / 2.0, (d - 1) / 2.0])
    return np.asarray(jnp.einsum("dhwc,rc->dhwr", grid, rot)
                      + jnp.asarray(trans) / half)


def test_euler_matrix_matches_jax_batched():
    rng = np.random.RandomState(0)
    angles = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    got = taug._euler_matrix(*t(angles).unbind(-1)).numpy()
    for a, g in zip(angles, got):
        np.testing.assert_allclose(g, np.asarray(jaug._euler_matrix(*a)),
                                   rtol=0, atol=GRID_ATOL)
        np.testing.assert_allclose(g @ g.T, np.eye(3), atol=1e-6)


@pytest.mark.parametrize("mode", ["both", "img", "seg"])
@pytest.mark.parametrize("seed", range(4))
def test_rigid_warp_from_jax_draws(mode, seed):
    angles, translation, ratio = (20.0, 10.0, 30.0), (2.0, 3.0, 1.0), 0.7
    image, seg = volumes(seed + 10)
    key = jax.random.PRNGKey(100 + seed)
    want_img, want_seg = jaug.random_rigid_warp(
        key, jnp.asarray(image[0]), jnp.asarray(seg[0]), angles, translation,
        ratio, mode)
    rad, trans, apply = jax_rigid_draws(key, angles, translation, ratio)
    grid = taug.rigid_grid(t(rad), t(trans), SHAPE).numpy()
    np.testing.assert_allclose(grid, jax_rigid_grid(rad, trans, SHAPE),
                               rtol=0, atol=GRID_ATOL)
    deform = taug.rigid_deform(t(rad)[None], t(trans)[None],
                               torch.tensor([apply]), SHAPE)
    if not apply:
        np.testing.assert_array_equal(deform[0].numpy(),
                                      np.asarray(jax_identity_grid(SHAPE)))
    got_img, got_seg = taug._rigid_pair(t(image), t(seg), deform, mode)
    np.testing.assert_allclose(got_img[0].numpy(), np.asarray(want_img),
                               rtol=0, atol=IMAGE_ATOL)
    flips = (got_seg[0].numpy() != np.asarray(want_seg)).mean()
    assert flips <= 1e-3, flips
    if mode == "seg":
        assert torch.equal(got_img, t(image))
    if mode == "img":
        assert torch.equal(got_seg, t(seg))


def test_rigid_labels_are_exact_on_the_jax_grid():
    """Nearest-neighbour labels (round half to even) on one grid equal
    JAX's bit for bit, out-of-volume samples (label 0) included."""
    rad = np.asarray([0.3, -0.2, 0.25], np.float32)
    trans = np.asarray([3.0, -2.0, 1.5], np.float32)
    grid = jax_rigid_grid(rad, trans, SHAPE).astype(np.float32)
    _, seg = volumes(5)
    from deepatlas_tpu.ops import grid_sample as jax_grid_sample
    want = jax_grid_sample(jnp.asarray(seg[..., None], jnp.float32),
                           jnp.asarray(grid)[None], mode="nearest")[..., 0]
    _, got = taug._warp_pair(t(seg[..., None]).float(), t(seg),
                             t(grid)[None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).mean() > (seg == 0).mean()   # samples outside


def test_bad_rigid_mode_raises_as_in_jax():
    image, seg = volumes(0)
    with pytest.raises(ValueError, match="Wrong rigid transformation mode"):
        jaug.random_rigid_warp(jax.random.PRNGKey(0), jnp.asarray(image[0]),
                               jnp.asarray(seg[0]), mode="all")
    with pytest.raises(ValueError, match="Wrong rigid transformation mode"):
        taug.random_rigid_warp([torch.Generator()], t(image), t(seg),
                               mode="all")
    augment = taug.make_augmenter({"rigid": {"mode": "all"}})
    with pytest.raises(ValueError, match="Wrong rigid transformation mode"):
        augment((0,), t(image), t(seg))


# ------------------------------------------------------------------ blur

@pytest.mark.parametrize("sigma,truncate,shape", [
    (0.7, 2.0, (9, 10, 11)), (1.5, 2.0, (6, 8, 7)), (0.2, 2.0, (5, 4, 3)),
    (1.0, 4.0, (12, 5, 9))])
def test_gaussian_blur_matches_jax(sigma, truncate, shape):
    image, _ = volumes(3, batch=2, shape=shape, channels=2)
    got = taug.gaussian_blur(t(image), sigma, truncate).numpy()
    for b in range(2):
        want = np.asarray(jaug.gaussian_blur(jnp.asarray(image[b]), sigma,
                                             truncate))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=BLUR_ATOL)


# -------------------------------------------------------------- augmenter

def jax_element_draws(key, config):
    """Element draws of JAX's ``augment_one`` (``split(key, 4)``; the
    B-spline's ``split`` into apply and field keys; the rigid draws; the
    blur's coin), in the port's ``Augmenter.draw`` layout."""
    k1, k2, k3, _ = jax.random.split(key, 4)
    b, r = config["bspline"], config["rigid"]
    k_apply, k_field = jax.random.split(k1)
    ctrl = jax_ctrl(k_field, b["mesh_size"], 2, b["deform_scale"], "Normal",
                    ())
    bs_apply = bool(jax.random.uniform(k_apply) < b["ratio"])
    rad, trans, rg_apply = jax_rigid_draws(k2, r["rotation_angles"],
                                           r["translation"], r["ratio"])
    blur = bool(jax.random.uniform(k3) < config["blur"]["ratio"])
    return ((ctrl, bs_apply), (rad, trans, rg_apply), (blur,))


@pytest.mark.parametrize("step", [0, 1, 2])
def test_augmenter_on_jax_draws_matches_jax(step):
    """The whole augmenter (B-spline, rigid, blur on a batch of 3) on the
    draws of JAX's ``make_augmenter`` for the same key."""
    image, seg = volumes(20 + step, batch=3)
    key = jax.random.fold_in(jax.random.PRNGKey(230), 2 ** 20 + step)
    want_img, want_seg = jaug.make_augmenter(CONFIG)(
        key, jnp.asarray(image), jnp.asarray(seg))
    per = [jax_element_draws(jax.random.fold_in(key, i), CONFIG)
           for i in range(3)]
    draws = {name: tuple(torch.stack([t(np.asarray(x)) for x in parts])
                         for parts in zip(*[p[j] for p in per]))
             for j, name in enumerate(("bspline", "rigid", "blur"))}
    augment = taug.make_augmenter(CONFIG)
    got_img, got_seg = augment.apply(draws, t(image), t(seg))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=IMAGE_ATOL)
    flips = (got_seg.numpy() != np.asarray(want_seg)).mean()
    assert flips <= 1e-3, flips
    assert got_seg.dtype == torch.int32


def test_make_augmenter_keys_and_defaults():
    assert taug.make_augmenter({}) is None
    assert taug.make_augmenter(None) is None
    assert jaug.make_augmenter({}) is None
    aug = taug.make_augmenter({"bspline": {"bspline_order": 3},
                               "rigid": {"rotation_angles": [1, 2, 3]},
                               "blur": {"ratio": 0.2}})
    assert aug.bspline_args == dict(mesh_size=(3, 3, 3), deform_scale=1.0,
                                    ratio=0.5, freeze_axes=(), order=3,
                                    random_mode="Normal")
    assert aug.rigid_args == dict(rotation_angles=(1, 2, 3),
                                  translation=(0.0, 0.0, 0.0), ratio=1.0)
    assert aug.rigid_mode == "both"
    assert (aug.sigma, aug.blur_ratio) == (0.7, 0.2)
    # an empty transform's dict is off, as in the JAX package's ``if blur:``
    assert not taug.make_augmenter({"blur": {}, "rigid": {"ratio": 1}}).blur
    # "order" wins over "bspline_order"
    aug = taug.make_augmenter({"bspline": {"order": 1, "bspline_order": 3,
                                           "freeze_axes": [2]}})
    assert aug.bspline_args["order"] == 1
    assert aug.bspline_args["freeze_axes"] == (2,)
    assert not aug.rigid and not aug.blur
    # only the enabled transforms draw
    assert set(aug.draw((0,), 2)) == {"bspline"}
    # images alone
    image, _ = volumes(1, batch=2)
    out, segs = aug((0,), t(image))
    assert segs is None and out.shape == image.shape


def test_one_warp_launch_per_batch_and_transform():
    """The image warps go through the warp kernel's entry point, unclamped,
    once per enabled warp over the whole batch (2 per batch here)."""
    image, seg = volumes(2, batch=3)
    aug = taug.make_augmenter(CONFIG)
    with mock.patch.object(kernels, "grid_sample",
                           wraps=kernels.grid_sample) as spy:
        out, labels = aug((230, 2 ** 20), t(image), t(seg))
    assert spy.call_count == 2
    for call in spy.call_args_list:
        vol, grid = call.args
        assert vol.shape == (3,) + SHAPE + (1,)
        assert grid.shape == (3,) + SHAPE + (3,)
        assert call.kwargs == {"max_disp": None}
    assert out.shape == image.shape and labels.shape == seg.shape
    # mode "seg" keeps the images: no image warp for the rigid draw
    aug = taug.make_augmenter(dict(CONFIG, rigid=dict(CONFIG["rigid"],
                                                      mode="seg")))
    with mock.patch.object(kernels, "grid_sample",
                           wraps=kernels.grid_sample) as spy:
        aug((230, 2 ** 20), t(image), t(seg))
    assert spy.call_count == 1


# ------------------------------------------------ the port's own draws

def test_control_point_statistics():
    scale = 3.0
    normal = torch.cat([taug.draw_bspline(taug.key_generator((7, i)),
                                          (3, 3, 3), scale)[0].flatten()
                        for i in range(40)])
    assert normal.numel() >= 10 ** 4
    assert abs(normal.std().item() / (scale / 2) - 1) < 0.05
    assert abs(normal.mean().item()) < 0.05 * scale
    uniform = torch.cat([taug.draw_bspline(
        taug.key_generator((8, i)), (3, 3, 3), scale,
        random_mode="Uniform")[0].flatten() for i in range(40)])
    assert uniform.min() >= 0 and uniform.max() < scale
    assert abs(uniform.mean().item() / (scale / 2) - 1) < 0.05


@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.9])
def test_apply_frequency_is_binomial(ratio):
    n = 4000
    aug = taug.make_augmenter({"bspline": {"ratio": ratio},
                               "rigid": {"ratio": ratio},
                               "blur": {"ratio": ratio}})
    draws = aug.draw((230, 2 ** 20 + 5), n)
    four_sigma = 4 * np.sqrt(n * ratio * (1 - ratio))
    for applied in (draws["bspline"][1], draws["rigid"][2],
                    draws["blur"][0]):
        assert applied.dtype == torch.bool and applied.shape == (n,)
        assert abs(applied.sum().item() - n * ratio) < four_sigma


def test_angle_and_translation_statistics():
    angles, trans, _ = (torch.stack(x) for x in zip(*[
        taug.draw_rigid(taug.key_generator((9, i)), (4.0, 10.0, 6.0),
                        (2.0, 1.0, 3.0)) for i in range(4000)]))
    deg = angles * (180.0 / np.pi)
    np.testing.assert_allclose(deg.std(dim=0).numpy(), [2.0, 5.0, 3.0],
                               rtol=0.05)
    np.testing.assert_allclose(trans.std(dim=0).numpy(), [1.0, 0.5, 1.5],
                               rtol=0.05)


def test_same_key_same_bits_other_step_other_output():
    image, seg = volumes(4, batch=2)
    aug = taug.make_augmenter(dict(CONFIG, bspline=dict(CONFIG["bspline"],
                                                        ratio=1.0)))
    a_img, a_seg = aug((230, 2 ** 20 + 3), t(image), t(seg))
    b_img, b_seg = aug((230, 2 ** 20 + 3), t(image), t(seg))
    assert torch.equal(a_img, b_img) and torch.equal(a_seg, b_seg)
    c_img, _ = aug((230, 2 ** 20 + 4), t(image), t(seg))
    assert not torch.equal(a_img, c_img)
    # the batch's elements draw from their own keys
    assert not torch.equal(a_img[0], a_img[1])
    # and the sides of a joint step from theirs
    d_img, _ = aug(taug.fold_in((230, 2 ** 20 + 3), 0), t(image), t(seg))
    e_img, _ = aug(taug.fold_in((230, 2 ** 20 + 3), 1), t(image), t(seg))
    assert not torch.equal(d_img, e_img)


# ------------------------------------------------------ the joint slice

def test_joint_experiment_augments_and_writes_the_jax_tags(tmp_path):
    """The joint experiment with the augmenter on both sides and image
    summaries (the default): finite metrics, each side augmented from its
    own sub-key, and the JAX experiment's scalar and image tags, steps and
    image shapes (its writer recorded by a stub)."""
    import chip_smoke
    from deepatlas_tpu.train import \
        DeepAtlasExperiment as JaxDeepAtlasExperiment
    from deepatlas_torch.train import DeepAtlasExperiment
    from tests.test_torch_patches import jax_writes, port_writes, read_scalars
    from tests.test_torch_train_deepatlas import SHAPE as JOINT_SHAPE
    from tests.test_torch_train_deepatlas import tiny_config

    chip_smoke.write_reg_corpus(str(tmp_path), seed=3, shape=JOINT_SHAPE,
                                max_shift=1.0)
    config = tiny_config(tmp_path, n_epochs=1, samples_per_epoch=2,
                         augmentation=CONFIG)
    # the JAX run without the augmenter: the tags do not depend on it
    jconfig = dict(config, log_dir=str(tmp_path / "jax_logs"),
                   augmentation=None, use_pallas_warp=False,
                   seg_model_settings=dict(config["seg_model_settings"],
                                           packed=False),
                   reg_model_settings=dict(config["reg_model_settings"],
                                           packed=False,
                                           use_pallas_warp=False))
    jconfig.pop("device")
    want = jax_writes(JaxDeepAtlasExperiment, jconfig)

    torch.set_num_threads(1)
    exp = DeepAtlasExperiment(config)
    keys = []
    real = taug.Augmenter.__call__

    def recorded(self, key, images, segs=None):
        keys.append(key)
        return real(self, key, images, segs)

    with mock.patch.object(taug.Augmenter, "__call__", recorded):
        exp.train()
    # two iterations (global_step 0 and 1), moving then fixed
    assert keys == [(230, 2 ** 20, 0), (230, 2 ** 20, 1),
                    (230, 2 ** 20 + 1, 0), (230, 2 ** 20 + 1, 1)]
    assert all(np.isfinite(s["value"]) for s in read_scalars(exp))
    got = port_writes(exp)
    assert sorted(got) == sorted(want)
    assert {c[1] for c in got if c[0] == "image"} == {
        "validation_reg/images", "validation_reg/disp_field",
        "validation_reg/masks", "validation_reg/deform_grid",
        "validation_seg/summary"}
