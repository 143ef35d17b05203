"""The deepatlas_torch segmentation experiment and its CLI, on the CPU.

Schedulers are held against the JAX package's own (same LR sequences and
state dicts); a tiny MindBoggle-layout corpus runs through
``SegmentationExperiment`` with ``device="cpu"`` (train, validate,
checkpoints, resume, ``test()``), and ``train_seg_torch.main`` runs end to
end with ``--device cpu`` at the recipe's 32 classes and crop.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from deepatlas_tpu.train import schedules as jax_schedules
from deepatlas_torch.data import NiftiImage, write_nifti
from deepatlas_torch.train import (SegmentationExperiment, initialize_from,
                                   load_checkpoint, make_scheduler,
                                   save_checkpoint, scheduler_from_restored)

import train_seg_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ schedulers

@pytest.mark.parametrize("mode,kwargs,metrics", [
    ("multiStep", dict(n_epochs=10, milestones=[0.5, 1], gamma=0.2), None),
    ("multiStep", dict(n_epochs=7, milestones=None, gamma=0.5), None),
    ("plateau", dict(n_epochs=10, valid_epoch_period=50),
     [0.1, 0.2, 0.2, 0.2, 0.2, 0.21, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2]),
    ("const", dict(n_epochs=5), None),
])
def test_schedulers_give_the_jax_lr_sequences(mode, kwargs, metrics):
    ours = make_scheduler(mode, 1e-3, **kwargs)
    theirs = jax_schedules.make_scheduler(mode, 1e-3, **kwargs)
    assert type(ours).__name__ == type(theirs).__name__
    for i in range(12):
        metric = metrics[i] if metrics else None
        assert ours.step(metric) == theirs.step(metric)
        assert ours.state_dict() == theirs.state_dict()
    # restore from checkpoint-style values (numpy scalars), or from nothing
    fresh = make_scheduler(mode, 1e-3, **kwargs)
    scheduler_from_restored(fresh, {k: np.float64(v) for k, v in
                                    ours.state_dict().items()})
    assert fresh.state_dict() == ours.state_dict()
    scheduler_from_restored(fresh, None)
    assert fresh.state_dict() == ours.state_dict()


# ------------------------------------------------------------- experiment

def make_mindboggle_corpus(root, names, shape=(12, 14, 12), n_classes=3):
    """Synthetic MindBoggle-layout corpus: blobby foreground labels whose
    intensity follows the label (learnable in a few steps)."""
    rng = np.random.RandomState(7)
    img_dir = root / "image_in_MNI152_normalized"
    seg_dir = root / "label_31_reID_merged"
    img_dir.mkdir(parents=True, exist_ok=True)
    seg_dir.mkdir(parents=True, exist_ok=True)
    d, h, w = shape
    for name in names:
        seg = np.zeros(shape, np.uint8)
        seg[d // 4:d // 2, h // 4:h // 2, w // 4:w // 2] = 1
        seg[d // 2:3 * d // 4, h // 2:3 * h // 4, w // 2:3 * w // 4] = 2
        img = (seg.astype(np.float32) / n_classes
               + rng.rand(*shape).astype(np.float32) * 0.1)
        write_nifti(img_dir / f"{name}.nii.gz", NiftiImage(img))
        write_nifti(seg_dir / f"{name}.nii.gz", NiftiImage(seg))


def tiny_config(root, n_classes=3, n_epochs=2):
    return dict(
        debug_mode=False, resume_dir="", random_seed=230, data="MindBoggle",
        n_epochs=n_epochs, samples_per_epoch=4, batch_size=1,
        valid_batch_size=1, print_batch_period=2, valid_epoch_period=1,
        save_ckpts_epoch_period=1,
        model="UNet_light",
        model_settings={"in_channel": 1, "n_classes": n_classes,
                        "bias": True, "BN": True},
        n_classes=n_classes,
        class_name={k: str(k) for k in range(1, n_classes)},
        crop_size=[2, 3, 2],
        loss="dice",
        loss_settings={"n_class": n_classes, "weight_type": "Uniform",
                       "no_bg": False, "softmax": True, "eps": 1e-6},
        learning_rate=1e-2, lr_mode="multiStep", milestones=[0.5, 1],
        gamma=0.2, num_samples=2, preload=True, device="cpu",
        data_dir=str(root), valid_data_dir=str(root),
        training_list_file=str(root / "train.txt"),
        validation_list_file=str(root / "valid.txt"),
        testing_list_file=str(root / "test.txt"),
        log_dir=str(root / "logs"),
    )


@pytest.fixture(scope="module")
def trained_experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("mb101")
    names = [f"scan{i}" for i in range(4)]
    make_mindboggle_corpus(root, names)
    for list_name in ("train.txt", "valid.txt", "test.txt"):
        (root / list_name).write_text("".join(f"{n}\n" for n in names))
    config = tiny_config(root)
    exp = SegmentationExperiment(config)
    exp.train()
    return exp, config, root


def read_scalars(exp):
    with open(os.path.join(exp.ckpoint_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_training_learns_and_logs_the_reference_tags(trained_experiment):
    exp, config, _ = trained_experiment
    assert exp.ckpoint_dir.endswith(os.path.join(
        "Seg_UNet_light_bias_BN_mb1010_2samples_batch_1_2epochs_dice_Uniform"
        "_lr_0.01_scheduler_multiStep", "230"))
    # blobs are trivially learnable: validation dice must beat chance
    assert exp.best_score > 0.3
    scalars = read_scalars(exp)
    losses = [s for s in scalars if s["tag"] == "loss/training"]
    # global_step = (epoch - 1) * iters + (i + 1) * batch, every 2 iters
    assert [s["step"] for s in losses] == [2, 4, 6, 8]
    assert losses[-1]["value"] < losses[0]["value"]
    tags = {s["tag"] for s in scalars}
    assert tags == {"loss/training", "learning_rate",
                    "throughput/ingest_wait_fraction",
                    "throughput/volumes_per_sec_per_chip",
                    "validation_MindBoggle/dice_avg",
                    "validation_MindBoggle/dice_1",
                    "validation_MindBoggle/dice_2"}
    # multiStep over 2 epochs: milestones at epochs 1 and 2
    lrs = [s["value"] for s in scalars if s["tag"] == "learning_rate"]
    assert lrs == pytest.approx([1e-2, 1e-2, 2e-3, 2e-3])
    assert exp.state.optimizer.param_groups[0]["lr"] == pytest.approx(4e-4)


def test_checkpoint_files_and_contents(trained_experiment):
    exp, _, _ = trained_experiment
    for name in ("checkpoint", "model_best", "train_config.json"):
        assert os.path.isfile(os.path.join(exp.ckpoint_dir, name))
    state, epoch, best = initialize_from(exp.ckpoint_dir)
    assert epoch == 2 and best == pytest.approx(exp.best_score)
    assert set(state) == {"epoch", "model", "optimizer", "best_score",
                          "scheduler"}
    assert state["scheduler"] == {"lr": pytest.approx(4e-4), "epoch": 2}
    assert state["optimizer"]["state"][0]["step"] == 8
    for k, v in exp.model.state_dict().items():
        assert torch.equal(state["model"][k], v), k


def test_test_entrypoint_writes_the_log(trained_experiment):
    exp, config, _ = trained_experiment
    exp2 = SegmentationExperiment(config)
    dice_per_class, dice_avg = exp2.test(best=True)
    assert dice_per_class.shape == (config["n_classes"] - 1,)
    np.testing.assert_allclose(dice_avg, exp.best_score, atol=1e-5)
    with open(os.path.join(exp.ckpoint_dir, "test_log.txt")) as f:
        log = f.read()
    assert "Testing Model:" in log and "model_best (" in log
    assert f"Dice_avg: {dice_avg}" in log and "Dice_2:" in log


def test_resume_continues_at_the_next_epoch(trained_experiment):
    exp, config, _ = trained_experiment
    cfg = dict(config)
    cfg["resume_dir"] = os.path.join(exp.ckpoint_dir, "checkpoint")
    cfg["n_epochs"] = 3
    exp3 = SegmentationExperiment(cfg)
    with mock.patch.object(exp3, "train_one_epoch",
                           wraps=exp3.train_one_epoch) as epochs:
        exp3.train()                    # runs only epoch 3
    assert epochs.call_count == 1
    assert exp3.current_epoch == 4
    assert exp3.best_score >= exp.best_score - 1e-6
    assert exp3.scheduler.epoch == 3
    assert exp3.state.optimizer.state_dict()["state"][0]["step"] == 12


def test_checkpoint_helpers(tmp_path):
    with pytest.raises(ValueError, match="no checkpoint found"):
        initialize_from(str(tmp_path / "nope"))
    save_checkpoint({"epoch": 1, "seg_best_score": 0.5, "model": {}}, False,
                    str(tmp_path))
    _, epoch, best = initialize_from(str(tmp_path / "checkpoint"))
    assert (epoch, best) == (1, 0.5)
    assert not (tmp_path / "model_best").exists()
    save_checkpoint({"epoch": 2, "model": {}}, True, str(tmp_path), "seg")
    assert load_checkpoint(str(tmp_path / "seg_model_best"))["epoch"] == 2
    with pytest.raises(ValueError, match="no best score key"):
        initialize_from(str(tmp_path / "seg_checkpoint"))


def test_unported_config_keys_and_missing_card_raise(tmp_path):
    config = tiny_config(tmp_path)
    for key, value in (("data_parallel", True), ("spatial_shards", 2),
                       ("augmentation", {"rigid": {}}),
                       ("patch_size", [8, 8, 8])):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SegmentationExperiment({**config, key: value})
    for device in (None, "cuda"):
        with mock.patch.object(torch.cuda, "is_available",
                               return_value=False), \
                pytest.raises(RuntimeError, match="CUDA is not available"):
            SegmentationExperiment({**config, "device": device})


# -------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def mindboggle_root(tmp_path_factory):
    """The layout ``train_seg.py`` expects: ``<root>/mindboggle`` with the
    MMRR-21 / NKI-RS-21 name lists, volumes that crop to 16^3."""
    root = tmp_path_factory.mktemp("data")
    mb = root / "mindboggle"
    names = [f"scan{i}" for i in range(3)]
    make_mindboggle_corpus(mb, names, shape=(30, 34, 30), n_classes=3)
    (mb / "MMRR-21-flip.txt").write_text("".join(f"{n}\n" for n in names[:2]))
    (mb / "NKI-RS-21-valid.txt").write_text(f"{names[2]}\n")
    (mb / "NKI-RS-21-train.txt").write_text(f"{names[2]}\n")
    return root


def test_cli_end_to_end_on_the_cpu(mindboggle_root, tmp_path, monkeypatch,
                                   capsys):
    """``train_seg_torch.main``: the recipe's config (32 classes, bf16,
    crop [0,10,7,14,8,7]), one epoch of 42 steps, validation, checkpoint and
    ``test()``."""
    monkeypatch.chdir(tmp_path)
    dice_per_class, dice_avg = train_seg_torch.main(
        ["--data-root", str(mindboggle_root), "--log-root", "logs",
         "--num-samples", "21", "--num-epochs", "1", "--device", "cpu"])
    assert dice_per_class.shape == (31,) and np.isfinite(dice_avg)
    out = capsys.readouterr().out
    assert "Epoch[1/1] iter 50" not in out and "Validation: Dice Avg:" in out
    run = tmp_path / "logs" / "MindBoggle" / (
        "Seg_UNet_light_bias_BN_mindboggle_21samples_batch_1_1epochs_dice_"
        "Uniform_lr_0.001_scheduler_multiStep") / "230"
    assert (run / "checkpoint").is_file() and (run / "test_log.txt").is_file()
    state = load_checkpoint(str(run / "checkpoint"))
    assert state["epoch"] == 1
    assert state["optimizer"]["state"][0]["step"] == 42
    assert state["model"]["head.weight"].shape == (16, 32)
    config = json.loads((run / "train_config.json").read_text())
    assert config["crop_size"] == [0, 10, 7, 14, 8, 7]
    assert config["model_settings"]["dtype"] == "bfloat16"
    assert "packed" not in config["model_settings"]
    # --test_only evaluates the saved checkpoint again
    again = train_seg_torch.main(
        ["--data-root", str(mindboggle_root), "--log-root", "logs",
         "--num-samples", "21", "--num-epochs", "1", "--device", "cpu", "-t"])
    np.testing.assert_allclose(again[1], dice_avg, atol=1e-6)


def test_cli_raises_without_a_card(mindboggle_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--data-root", str(mindboggle_root), "--num-epochs", "1"]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_seg_torch.main(argv)
    with pytest.raises(ValueError, match="21 or 65"):
        train_seg_torch.main(argv + ["--device", "cpu", "--num-samples", "5"])
    assert not (tmp_path / "logs").exists()


def test_training_modules_import_no_jax():
    code = (
        "import sys\n"
        "import train_seg_torch, deepatlas_torch.train, "
        "deepatlas_torch.losses, deepatlas_torch.utils, deepatlas_torch.ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deepatlas_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
