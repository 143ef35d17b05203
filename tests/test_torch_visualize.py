"""Image summaries on the CPU: ``deepatlas_torch/utils/visualize.py``
against ``deepatlas_tpu/utils/visualize.py``, the writer's ``images/``
layout and TensorBoard mirror, and the registration experiment's summaries
against the JAX experiment's tags.

Every panel is compared exactly: the same numpy on the same inputs, and
for the matplotlib panels the same rendered pixels (these tests need
matplotlib, which the port imports only inside those two functions).
"""
import importlib.util
import os
from unittest import mock

import numpy as np
import pytest
import torch

from deepatlas_tpu.utils import visualize as jvis
from deepatlas_torch.train import RegistrationExperiment, ScalarWriter
from deepatlas_torch.train.segmentation import summary_slices
from deepatlas_torch.utils import visualize as tvis

import chip_smoke
from tests.test_torch_patches import jax_writes, port_writes
from tests.test_torch_train_reg import SHAPE as REG_SHAPE
from tests.test_torch_train_reg import tiny_config as reg_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seg_inputs(seed, batch=5, shape=(6, 9, 7), n_classes=4):
    rng = np.random.RandomState(seed)
    images = rng.uniform(-0.2, 1.2, (batch, *shape, 1)).astype(np.float32)
    truths = rng.randint(0, n_classes, (batch, *shape)).astype(np.uint8)
    logits = rng.randn(batch, *shape, n_classes).astype(np.float32)
    return images, truths, logits


def reg_inputs(seed, batch=2, shape=(8, 10, 9)):
    rng = np.random.RandomState(seed)
    vols = [rng.uniform(-0.1, 1.1, (batch, *shape, 1)).astype(np.float32)
            for _ in range(3)]
    disp = rng.randn(batch, *shape, 3).astype(np.float32) * 0.1
    deform = disp + rng.uniform(-1, 1, (batch, *shape, 3)).astype(np.float32)
    segs = [rng.randint(0, 5, (batch, *shape)) for _ in range(3)]
    return vols, disp, deform, segs


@pytest.mark.parametrize("n", [1, 2, 5, 33])
def test_palette(n):
    np.testing.assert_array_equal(tvis._palette(n), jvis._palette(n))


@pytest.mark.parametrize("overlap,n_labels,alpha", [
    (False, None, 0.7), (True, None, 0.7), (True, 9, 0.4), (False, 3, 0.7)])
def test_labels2colors(overlap, n_labels, alpha):
    rng = np.random.RandomState(1)
    labels = rng.randint(0, 6, (7, 11))
    image = rng.uniform(-0.5, 1.5, (7, 11)).astype(np.float32)
    got = tvis.labels2colors(labels, image, overlap, alpha, n_labels)
    want = jvis.labels2colors(labels, image, overlap, alpha, n_labels)
    assert got.shape == (3, 7, 11)
    np.testing.assert_array_equal(got, want)


def test_labels2colors_needs_an_image_to_overlap():
    with pytest.raises(ValueError, match="background"):
        tvis.labels2colors(np.zeros((2, 2), int), None, True)


def test_grid_and_slices_padding():
    rng = np.random.RandomState(2)
    tiles = [rng.rand(3, h, w).astype(np.float32)
             for h, w in ((4, 5), (6, 3), (2, 2))]
    for pad, value in ((2, 1.0), (0, 0.5)):
        np.testing.assert_array_equal(tvis._grid(tiles, pad, value),
                                      jvis._grid(tiles, pad, value))
        np.testing.assert_array_equal(tvis.slices_padding(tiles, pad, value),
                                      jvis.slices_padding(tiles, pad, value))


@pytest.mark.parametrize("kw", [{}, {"maxoutput": 2, "slice_ind": 1},
                                {"overlap": False, "alpha": 0.3}])
def test_segmentation_summary(kw):
    images, truths, logits = seg_inputs(3)
    got = tvis.make_segmentation_image_summary(images, truths, logits, **kw)
    want = jvis.make_segmentation_image_summary(images, truths, logits, **kw)
    assert got.shape[0] == 3 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch,depth", [(1, 6), (5, 7), (2, 1)])
def test_summary_of_the_mid_slices_is_the_whole_summary(batch, depth):
    """The experiments copy only the mid-depth slices of the first four
    elements to the host (``summary_slices``, cut on the logits' device):
    the picture equals JAX's of the whole arrays."""
    images, truths, logits = seg_inputs(4, batch, (depth, 9, 7))
    cut = summary_slices(images, truths,
                         torch.from_numpy(logits).to(torch.bfloat16))
    assert cut[2].shape == (min(batch, 4), 1, 9, 7, 4)
    assert cut[2].dtype == np.float32
    rounded = torch.from_numpy(logits).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        tvis.make_segmentation_image_summary(*cut),
        jvis.make_segmentation_image_summary(images, truths, rounded))


@pytest.mark.parametrize("with_segs,n_samples", [(True, 1), (False, 1),
                                                 (True, 2)])
def test_registration_summary(with_segs, n_samples):
    (src, tgt, warped), disp, deform, segs = reg_inputs(5)
    seg_args = segs if with_segs else (None, None, None)
    got = tvis.make_registration_image_summary(src, tgt, warped, disp,
                                               deform, *seg_args, n_samples)
    want = jvis.make_registration_image_summary(src, tgt, warped, disp,
                                                deform, *seg_args, n_samples)
    assert set(got) == set(want) == ({"images", "disp_field", "masks"}
                                     if with_segs else
                                     {"images", "disp_field"})
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("background", [True, False])
def test_deform_grid(background):
    assert importlib.util.find_spec("matplotlib") is not None
    _, _, deform, _ = reg_inputs(6, 1, (4, 24, 30))
    bg = np.clip(reg_inputs(7, 1, (4, 24, 30))[0][0][0, 2, ..., 0], 0, 1) \
        if background else None
    got = tvis.generate_deform_grid(deform[0, 2, :, :, :2], bg)
    want = jvis.generate_deform_grid(deform[0, 2, :, :, :2], bg)
    assert got.shape[0] == 3 and 0 <= got.min() and got.max() <= 1
    np.testing.assert_array_equal(got, want)


def test_plot_grad_flow_from_a_dict_and_named_parameters():
    rng = np.random.RandomState(8)
    grads = {"conv0/kernel": rng.randn(3, 3, 3, 1, 4).astype(np.float32),
             "conv0/bias": rng.randn(4).astype(np.float32),
             "head/kernel": rng.randn(4, 2).astype(np.float32)}
    want = jvis.plot_grad_flow(grads)
    np.testing.assert_array_equal(tvis.plot_grad_flow(grads), want)
    np.testing.assert_array_equal(
        tvis.plot_grad_flow({k: torch.from_numpy(v)
                             for k, v in grads.items()}), want)
    # a module's named parameters, in its own order, by their .grad
    module = torch.nn.Module()
    for name in sorted(grads):
        p = torch.nn.Parameter(torch.zeros(grads[name].shape))
        p.grad = torch.from_numpy(grads[name])
        module.register_parameter(name.replace("/", "_"), p)
    module.register_parameter("frozen", torch.nn.Parameter(torch.zeros(2)))
    renamed = {k.replace("/", "_"): v for k, v in grads.items()}
    np.testing.assert_array_equal(
        tvis.plot_grad_flow(module.named_parameters()),
        jvis.plot_grad_flow(renamed))


def test_visualize_imports_no_matplotlib_until_called():
    import subprocess
    import sys
    code = ("import sys, deepatlas_torch.utils.visualize\n"
            "sys.exit('matplotlib' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=chip_smoke.REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------------------- the writer

def test_writer_images_layout_and_tensorboard_mirror(tmp_path):
    writer = ScalarWriter(str(tmp_path))
    img = np.random.RandomState(0).rand(3, 5, 7)
    writer.add_image("validation/images", img, 12)
    writer.add_image("training", img.astype(np.float32), 4)
    writer.add_scalar("loss/training", 0.5, 4)
    with pytest.raises(ValueError, match="expected a"):
        writer.add_image("bad", img[0], 4)
    assert writer.tensorboard is not None
    writer.close()
    saved = np.load(tmp_path / "images" / "validation__images" / "12.npy")
    assert saved.dtype == np.float32
    np.testing.assert_array_equal(saved, img.astype(np.float32))
    assert (tmp_path / "images" / "training" / "4.npy").is_file()
    assert (tmp_path / "scalars.jsonl").is_file()
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    events = EventAccumulator(str(tmp_path))
    events.Reload()
    assert sorted(events.Tags()["images"]) == ["training",
                                               "validation/images"]
    assert events.Tags()["scalars"] == ["loss/training"]
    assert [e.step for e in events.Images("validation/images")] == [12]


def test_writer_without_tensorboard(tmp_path):
    with mock.patch.dict("sys.modules",
                         {"torch.utils.tensorboard": None}):
        writer = ScalarWriter(str(tmp_path))
    assert writer.tensorboard is None
    writer.add_image("a/b", np.zeros((3, 2, 2)), 1)
    writer.add_scalar("a", 1.0, 1)
    writer.close()
    assert (tmp_path / "images" / "a__b" / "1.npy").is_file()
    assert not list(tmp_path.glob("events.out.tfevents.*"))


# ------------------------------------------------ the experiments' summaries

@pytest.fixture(scope="module")
def reg_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("reg")
    chip_smoke.write_reg_corpus(str(root), seed=3, shape=REG_SHAPE,
                                max_shift=1.0)
    return root


def test_registration_summaries_write_the_jax_tags(reg_corpus, tmp_path):
    """``image_summary`` defaults to True as in the JAX package: each
    validation writes the first pair's panels and the contour grid, under
    the JAX experiment's tags, steps and shapes."""
    from deepatlas_tpu.train import \
        RegistrationExperiment as JaxRegistrationExperiment

    config = reg_config(reg_corpus, n_epochs=1, samples_per_epoch=2,
                        log_dir=str(tmp_path / "logs"))
    jconfig = dict(config, log_dir=str(tmp_path / "jax_logs"),
                   model_settings=dict(config["model_settings"],
                                       packed=False, use_pallas_warp=False))
    jconfig.pop("device")
    want = jax_writes(JaxRegistrationExperiment, jconfig)
    exp = RegistrationExperiment(config)
    exp.train()
    got = port_writes(exp)
    assert sorted(got) == sorted(want)
    assert {c[1] for c in got if c[0] == "image"} == {
        "validation/images", "validation/disp_field", "validation/masks",
        "validation/deform_grid"}


def test_registration_summaries_off_and_without_matplotlib(reg_corpus,
                                                           tmp_path, capsys):
    config = reg_config(reg_corpus, n_epochs=1, samples_per_epoch=2,
                        log_dir=str(tmp_path / "off"))
    exp = RegistrationExperiment(dict(config, image_summary=False))
    exp.train()
    assert not os.path.exists(os.path.join(exp.ckpoint_dir, "images"))
    # matplotlib absent: every other panel, and one line naming the tag
    exp = RegistrationExperiment(dict(config, log_dir=str(tmp_path / "nm")))
    real = importlib.util.find_spec
    with mock.patch.object(
            importlib.util, "find_spec",
            lambda name, *a: None if name == "matplotlib" else real(name,
                                                                    *a)):
        exp.train()
    out = capsys.readouterr().out
    assert "image summary validation/deform_grid not written" in out
    images = sorted(os.listdir(os.path.join(exp.ckpoint_dir, "images")))
    assert images == ["validation__disp_field", "validation__images",
                      "validation__masks"]

