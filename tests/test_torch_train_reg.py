"""The deepatlas_torch registration experiment and its CLI, on the CPU.

The pairwise datasets and the loader's tuple batches are held against the
JAX package's; a tiny MindBoggle-layout corpus of deformed textures (the
corpus of ``chip_smoke.py``, cut down) runs through
``RegistrationExperiment`` with ``device="cpu"`` (train, validate,
checkpoints, resume, ``test()``) and through ``train_reg_torch.main
--device cpu`` at the recipe's width; a float32 run of the recipe's 42
steps must bring the similarity loss down (the CPU rehearsal of the check
``chip_smoke.py`` makes on the card); a JAX registration checkpoint crosses
with ``tools/flax_ckpt_to_torch.py``.
"""
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.data import DataLoader as JaxDataLoader
from deepatlas_tpu.data import get_reg_dataset as jax_get_reg_dataset
from deepatlas_torch.data import (Compose, DataLoader, VolumeToArray,
                                  get_reg_dataset)
from deepatlas_torch.train import (RegistrationExperiment, initialize_from,
                                   load_checkpoint, registration)

import chip_smoke
import train_reg_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# volumes that the recipe's crop [0, 10, 7, 14, 8, 7] cuts to 24 x 28 x 24
SHAPE = (38, 46, 38)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``<root>/mindboggle`` as ``train_reg.py`` expects it: 4 training
    volumes, 2 for validation and test, all smooth deformations (up to one
    voxel) of one textured, labelled base."""
    root = tmp_path_factory.mktemp("data")
    names = chip_smoke.write_reg_corpus(str(root), seed=3, shape=SHAPE,
                                        max_shift=1.0)
    assert len(names) == 6
    return root


# ------------------------------------------------------------------ data

def test_pair_datasets_and_tuple_batches_match_jax(corpus):
    mb = corpus / "mindboggle"
    assert get_reg_dataset("MindBoggle").__name__ == "RegDataSetMindBoggle"
    for key in ("OAI", "OASIS", "LPBA40", "CUMC12", "IBSR18", "MGH10"):
        assert get_reg_dataset(key).__name__ == \
            jax_get_reg_dataset(key).__name__
    with pytest.raises(ValueError, match="Wrong dataset"):
        get_reg_dataset("nope")
    args = (str(mb / "MMRR-21-flip.txt"), str(mb))
    ours = get_reg_dataset("MindBoggle")(
        *args, pre_transform=Compose([VolumeToArray()]), n_samples=3)
    from deepatlas_tpu.data import Compose as JCompose
    from deepatlas_tpu.data import VolumeToArray as JVolumeToArray
    theirs = jax_get_reg_dataset("MindBoggle")(
        *args, pre_transform=JCompose([JVolumeToArray()]), n_samples=3)
    assert len(ours) == len(theirs) == 6 and ours.length == 3
    for pair_id in range(6):
        assert ours.pair_indices(pair_id, 3) == theirs.pair_indices(pair_id, 3)
        (m, f), (jm, jf) = ours[pair_id], theirs[pair_id]
        assert (m["name"], f["name"]) == (jm["name"], jf["name"])
        assert m["name"] != f["name"]
        np.testing.assert_array_equal(m["image"], jm["image"])
        np.testing.assert_array_equal(f["segmentation"], jf["segmentation"])
    for kw in (dict(prefetch=0, num_workers=1), dict(prefetch=2)):
        batches = list(DataLoader(ours, batch_size=1, shuffle=True, seed=5,
                                  **kw))
        jbatches = list(JaxDataLoader(theirs, batch_size=1, shuffle=True,
                                      seed=5, **kw))
        assert len(batches) == len(jbatches) == 6
        for (bm, bf), (jbm, jbf) in zip(batches, jbatches):
            assert isinstance(bm, dict) and bm["name"] == jbm["name"]
            assert bf["name"] == jbf["name"]
            assert bm["image"].shape == (1,) + SHAPE + (1,)
            np.testing.assert_array_equal(bm["image"], jbm["image"])
            np.testing.assert_array_equal(bf["segmentation"],
                                          jbf["segmentation"])
            # a pair's members do not share a buffer
            assert not np.shares_memory(bm["image"], bf["image"])


# ------------------------------------------------------------ experiment

def tiny_config(root, n_epochs=2, **over):
    mb = root / "mindboggle"
    config = dict(
        debug_mode=False, resume_dir="", random_seed=230, data="MindBoggle",
        n_epochs=n_epochs, samples_per_epoch=4, batch_size=1,
        print_batch_period=2, valid_epoch_period=1,
        save_ckpts_epoch_period=1,
        model="voxel_morph_cvpr",
        model_settings={"enc_filters": [4, 8, 8, 8, 8],
                        "dec_filters": [8, 8, 8, 4, 4], "max_disp": 3},
        n_classes=32, crop_size=[0, 10, 7, 14, 8, 7],
        loss="lncc", loss_settings={"filter_size": 9},
        reg_loss="bendingEnergy", reg_loss_settings={}, reg_weight=1.0,
        max_validation_pairs=2,
        learning_rate=1e-2, lr_mode="multiStep", milestones=[0.5, 1],
        gamma=0.2, num_samples=4, preload=True, device="cpu",
        data_dir=str(mb), valid_data_dir=str(mb),
        training_list_file=str(mb / "MMRR-21-flip.txt"),
        validation_list_file=str(mb / "NKI-RS-21-valid.txt"),
        testing_list_file=str(mb / "NKI-RS-21-train.txt"),
        log_dir=str(root / "logs"),
    )
    config.update(over)
    return config


@pytest.fixture(scope="module")
def trained_experiment(corpus):
    config = tiny_config(corpus)
    exp = RegistrationExperiment(config)
    exp.train()
    return exp, config


def test_training_logs_the_reference_tags(trained_experiment, corpus):
    exp, _ = trained_experiment
    assert exp.ckpoint_dir.endswith(os.path.join(
        "Reg_voxel_morph_cvpr_mindboggle_2epochs_lncc_bendingEnergy_w1.0_lr_"
        "0.01_scheduler_multiStep", "230"))
    with open(os.path.join(exp.ckpoint_dir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    assert {s["tag"] for s in scalars} == {
        "loss/training", "loss/similarity", "loss/regularization",
        "learning_rate", "validation_MindBoggle/dice_avg",
        "validation_MindBoggle/folding_fraction"}
    losses = [s for s in scalars if s["tag"] == "loss/training"]
    # global_step = ((epoch - 1) * iters + i + 1) * batch, every 2 iters
    assert [s["step"] for s in losses] == [2, 4, 6, 8]
    sims = [s["value"] for s in scalars if s["tag"] == "loss/similarity"]
    regs = [s["value"] for s in scalars if s["tag"] == "loss/regularization"]
    for loss, sim, reg in zip(losses, sims, regs):
        assert np.isfinite(loss["value"])
        assert loss["value"] == pytest.approx(sim + reg, abs=1e-5)
    lrs = [s["value"] for s in scalars if s["tag"] == "learning_rate"]
    assert lrs == pytest.approx([1e-2, 1e-2, 2e-3, 2e-3])
    assert exp.state.optimizer.param_groups[0]["lr"] == pytest.approx(4e-4)
    dice = [s["value"] for s in scalars
            if s["tag"] == "validation_MindBoggle/dice_avg"]
    assert len(dice) == 2 and max(dice) == pytest.approx(exp.best_score)
    assert 0.0 < exp.best_score < 1.0


def test_checkpoint_carries_the_reg_best_score(trained_experiment):
    exp, _ = trained_experiment
    for name in ("checkpoint", "model_best", "train_config.json"):
        assert os.path.isfile(os.path.join(exp.ckpoint_dir, name))
    state, epoch, best = initialize_from(exp.ckpoint_dir)
    assert epoch == 2 and best == pytest.approx(exp.best_score)
    assert set(state) == {"epoch", "model", "optimizer", "reg_best_score",
                          "scheduler"}
    assert state["scheduler"] == {"lr": pytest.approx(4e-4), "epoch": 2}
    assert state["optimizer"]["state"][0]["step"] == 8
    for k, v in exp.model.state_dict().items():
        assert torch.equal(state["model"][k], v), k


def test_test_entrypoint_writes_the_log(trained_experiment):
    exp, config = trained_experiment
    exp2 = RegistrationExperiment(config)
    dice_per_class, dice_avg, folding = exp2.test(best=True)
    assert dice_per_class.shape == (31,)
    np.testing.assert_allclose(dice_avg, exp.best_score, atol=1e-5)
    assert 0.0 <= folding < 1.0
    with open(os.path.join(exp.ckpoint_dir, "test_log.txt")) as f:
        log = f.read()
    assert "Testing Model:" in log and "model_best (" in log
    assert f"Dice_avg: {dice_avg} folding: {folding}" in log


def test_resume_continues_at_the_next_epoch(trained_experiment):
    exp, config = trained_experiment
    cfg = dict(config, n_epochs=3,
               resume_dir=os.path.join(exp.ckpoint_dir, "checkpoint"))
    exp3 = RegistrationExperiment(cfg)
    with mock.patch.object(exp3, "train_one_epoch",
                           wraps=exp3.train_one_epoch) as epochs:
        exp3.train()                    # runs only epoch 3
    assert epochs.call_count == 1
    assert exp3.current_epoch == 4
    assert exp3.best_score >= exp.best_score - 1e-6
    assert exp3.scheduler.epoch == 3
    assert exp3.state.optimizer.state_dict()["state"][0]["step"] == 12


def test_unported_config_keys_and_missing_card_raise(corpus):
    config = tiny_config(corpus)
    for key, value in (("data_parallel", True), ("spatial_shards", 2),
                       ("image_summary", True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RegistrationExperiment({**config, key: value})
    for device in (None, "cuda"):
        with mock.patch.object(torch.cuda, "is_available",
                               return_value=False), \
                pytest.raises(RuntimeError, match="CUDA is not available"):
            RegistrationExperiment({**config, "device": device})
    # a setting that chooses a TPU execution path has no counterpart
    settings = dict(config["model_settings"], packed=True)
    exp = RegistrationExperiment({**config, "model_settings": settings})
    with pytest.raises(TypeError, match="packed"):
        exp.setup_model()


def test_similarity_falls_over_the_recipes_42_float32_steps(corpus, tmp_path,
                                                            monkeypatch):
    """The recipe at full width in float32 on the tiny corpus: the mean
    similarity loss of the last 10 steps lies below the first 10's, and
    every metric is finite."""
    monkeypatch.chdir(tmp_path)
    args = train_reg_torch.parse_args(
        ["--data-root", str(corpus), "--log-root", "logs", "--num-samples",
         "21", "--num-epochs", "1", "--device", "cpu"])
    config = train_reg_torch.build_config(args)
    config["model_settings"]["dtype"] = "float32"
    metrics = []
    make = registration.make_reg_train_step

    def factory(*a, **kw):
        step = make(*a, **kw)

        def recorded(state, moving, fixed):
            out = step(state, moving, fixed)
            metrics.append({k: float(v) for k, v in out[1].items()})
            return out

        return recorded

    with mock.patch.object(registration, "make_reg_train_step", factory):
        RegistrationExperiment(config).train()
    assert len(metrics) == 42
    assert all(set(m) == {"loss", "sim", "reg", "disp_overflow"}
               and np.all(np.isfinite(list(m.values()))) for m in metrics)
    sims = [m["sim"] for m in metrics]
    assert np.mean(sims[-10:]) < np.mean(sims[:10]) - 0.02


# -------------------------------------------------------------------- CLI

def test_cli_end_to_end_on_the_cpu(corpus, tmp_path, monkeypatch, capsys):
    """``train_reg_torch.main``: the recipe's config (VoxelMorph at full
    width in bf16, crop [0,10,7,14,8,7], LNCC-9 + bending energy), one epoch
    of 42 steps, validation, checkpoint and ``test()``."""
    monkeypatch.chdir(tmp_path)
    argv = ["--data-root", str(corpus), "--log-root", "logs",
            "--num-samples", "21", "--num-epochs", "1",
            "--max-validation-pairs", "2", "--device", "cpu"]
    dice_per_class, dice_avg, folding = train_reg_torch.main(argv)
    assert dice_per_class.shape == (31,)
    assert np.isfinite(dice_avg) and np.isfinite(folding)
    out = capsys.readouterr().out
    assert "Validation: Dice Avg:" in out and " folding " in out
    run = tmp_path / "logs" / "MindBoggle" / (
        "Reg_voxel_morph_cvpr_mindboggle_1epochs_lncc_bendingEnergy_w1.0_lr_"
        "0.001_scheduler_multiStep") / "230"
    assert (run / "checkpoint").is_file() and (run / "test_log.txt").is_file()
    state = load_checkpoint(str(run / "checkpoint"))
    assert state["epoch"] == 1 and "reg_best_score" in state
    assert state["optimizer"]["state"][0]["step"] == 42
    assert state["model"]["head.weight"].shape == (3, 3, 3, 24, 3)
    config = json.loads((run / "train_config.json").read_text())
    assert config["crop_size"] == [0, 10, 7, 14, 8, 7]
    assert config["model_settings"] == {"max_disp": 8, "dtype": "bfloat16"}
    assert config["loss"] == "lncc" and config["reg_loss"] == "bendingEnergy"
    again = train_reg_torch.main(argv + ["-t"])
    np.testing.assert_allclose(again[1], dice_avg, atol=1e-6)
    # with a period of 2 the training lines, disp_overflow included, print
    monkeypatch.setattr(sys, "argv", ["train_reg_torch.py"])
    debug = train_reg_torch.parse_args(argv + ["--debug"])
    assert train_reg_torch.build_config(debug)["debug_mode"] is True


def test_cli_raises_without_a_card(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--data-root", str(corpus), "--num-epochs", "1"]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_reg_torch.main(argv)
    with pytest.raises(ValueError, match="21 or 65"):
        train_reg_torch.main(argv + ["--device", "cpu", "--num-samples", "5"])
    assert not (tmp_path / "logs").exists()
    for flag in ("--no-pallas-warp", "--no-packed", "--data-parallel"):
        with pytest.raises(SystemExit):
            train_reg_torch.parse_args(argv + [flag])


def test_a_jax_registration_checkpoint_crosses(tmp_path, rng):
    """``tools/flax_ckpt_to_torch.py --model voxel_morph_cvpr``: weights,
    Adam state, ``reg_best_score``, epoch and scheduler of a JAX
    registration checkpoint after one JAX step."""
    from deepatlas_tpu.losses import get_loss_function as jax_get_loss
    from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVoxelMorph
    from deepatlas_tpu.train import save_checkpoint as jax_save
    from deepatlas_tpu.train.reg_steps import make_reg_train_step
    from deepatlas_tpu.train.steps import TrainState, make_optimizer
    from deepatlas_torch.models import (VoxelMorphCVPR2018,
                                        voxelmorph_from_flax)
    from tools import flax_ckpt_to_torch

    vol = (1, 16, 16, 16, 1)
    jmodel = JaxVoxelMorph()
    moving = jnp.asarray(rng.rand(*vol).astype(np.float32))
    fixed = jnp.asarray(rng.rand(*vol).astype(np.float32))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), moving, fixed)
    state = TrainState.create(apply_fn=jmodel.apply,
                              params=variables["params"], batch_stats={},
                              tx=make_optimizer(1e-3))
    step = make_reg_train_step(jax_get_loss("lncc")(filter_size=9),
                               jax_get_loss("bendingEnergy")(), 1.0)
    state, _ = step(state, moving, fixed)
    jax_save({"epoch": 4, "reg_best_score": 0.25, "params": state.params,
              "opt_state": state.opt_state,
              "scheduler": {"lr": 2e-4, "epoch": 4}}, True,
             str(tmp_path / "jax_ckpt"))
    flax_ckpt_to_torch.main(["--ckpt", str(tmp_path / "jax_ckpt" / "model_best"),
                             "--out", str(tmp_path / "torch_ckpt"),
                             "--model", "voxel_morph_cvpr"])
    restored, epoch, best = initialize_from(str(tmp_path / "torch_ckpt"))
    assert (epoch, best) == (4, 0.25) and "reg_best_score" in restored
    assert restored["scheduler"] == {"lr": pytest.approx(2e-4), "epoch": 4.0}
    model = VoxelMorphCVPR2018()
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    want = voxelmorph_from_flax({"params": params}, model)
    assert set(restored["model"]) == set(want)
    for k, v in want.items():
        assert torch.equal(restored["model"][k], v), k
    model.load_state_dict(restored["model"])
    opt = torch.optim.Adam(model.parameters())
    opt.load_state_dict(restored["optimizer"])
    moments = opt.state[model.head.weight]
    assert float(moments["step"]) == 1.0
    mu = np.asarray(state.opt_state.inner_state[0].mu["Conv_0"]["kernel"])
    np.testing.assert_array_equal(moments["exp_avg"].numpy(), mu)
    with pytest.raises(SystemExit):
        flax_ckpt_to_torch.main(       # a U-Net needs its class count
            ["--ckpt", str(tmp_path / "jax_ckpt" / "model_best"),
             "--out", str(tmp_path / "x")])


def test_registration_modules_import_no_jax():
    code = (
        "import sys\n"
        "import chip_smoke, train_reg_torch, deepatlas_torch.train, "
        "deepatlas_torch.kernels, deepatlas_torch.models, "
        "deepatlas_torch.losses, deepatlas_torch.metrics, "
        "deepatlas_torch.ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'deepatlas_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
