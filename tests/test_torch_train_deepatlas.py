"""The deepatlas_torch joint DeepAtlas experiment and its CLI, on the CPU.

A tiny MindBoggle-layout corpus of deformed, labelled textures (the corpus
of ``chip_smoke.py``, cut down to 24^3 after the recipe's crop) runs through
``DeepAtlasExperiment`` with ``device="cpu"`` (alternating phases,
validation, checkpoints carrying both nets, resume, ``test()``) and through
``train_deepatlas_torch.main --device cpu`` at the recipe's width, where
every seg-phase label regime and the reg phase's label substitution must
run.  The overflow guard is held against ``deepatlas_tpu.train.guard`` and
its ladder against the JAX experiment's on the same overflow sequence; a
JAX joint checkpoint crosses with ``tools/flax_ckpt_to_torch.py --model
deepatlas``.
"""
import json
import os
import time
import types
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.pallas.warp import MAX_PACKED_DISP
from deepatlas_tpu.train import deepatlas as jax_deepatlas
from deepatlas_tpu.train import guard as jax_guard
from deepatlas_torch.train import (DeepAtlasExperiment, DispOverflowGuard,
                                   deepatlas, initialize_from,
                                   load_checkpoint, make_guard, reg_steps)

from deepatlas_torch.data import endless
from deepatlas_torch.utils import spans_between

import chip_smoke
import train_deepatlas_torch

# volumes that the recipe's crop [0, 10, 7, 14, 8, 7] cuts to 24 x 24 x 24
SHAPE = (38, 42, 38)


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
    """``<root>/mindboggle`` as ``train_deepatlas.py`` expects it: 4
    training volumes, 2 for validation and test."""
    root = tmp_path_factory.mktemp("data")
    names = chip_smoke.write_reg_corpus(str(root), seed=3, shape=SHAPE,
                                        max_shift=1.0)
    assert len(names) == 6
    return root


def tiny_config(root, n_epochs=2, **over):
    mb = root / "mindboggle"
    config = dict(
        debug_mode=False, resume_dir="", random_seed=230, data="MindBoggle",
        n_epochs=n_epochs, samples_per_epoch=4, batch_size=1,
        print_batch_period=2, valid_epoch_period=1,
        save_ckpts_epoch_period=1,
        seg_model="UNet_light",
        seg_model_settings={"in_channel": 1, "n_classes": 32, "bias": True,
                            "BN": True},
        reg_model="voxel_morph_cvpr",
        reg_model_settings={"enc_filters": [4, 8, 8, 8, 8],
                            "dec_filters": [8, 8, 8, 4, 4], "max_disp": 3},
        max_disp=3, n_classes=32, n_labeled=2,
        crop_size=[0, 10, 7, 14, 8, 7],
        sim_loss="lncc", sim_loss_settings={"filter_size": 9},
        reg_loss="bendingEnergy", reg_loss_settings={},
        seg_loss="dice",
        seg_loss_settings={"n_class": 32, "weight_type": "Uniform",
                           "no_bg": False, "softmax": True, "eps": 1e-6},
        reg_weight=1.0, anatomy_weight=3.0, supervised_weight=1.0,
        max_validation_pairs=2,
        learning_rate=1e-3, lr_mode="multiStep", milestones=[0.5, 1],
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
    exp = DeepAtlasExperiment(config)
    exp.train()
    return exp, config


# ------------------------------------------------------------ experiment

def test_training_alternates_and_logs_the_reference_tags(trained_experiment):
    exp, _ = trained_experiment
    assert exp.ckpoint_dir.endswith(os.path.join(
        "DeepAtlas_mindboggle_UNet_light_2labeled_2epochs_lr_0.001", "230"))
    # semi-supervision: the first n_labeled names of the training list
    assert exp.labeled_names == {"synth_0", "synth_1"}
    with open(os.path.join(exp.ckpoint_dir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    tags = {s["tag"] for s in scalars}
    assert tags == {"seg/loss", "seg/supervised", "seg/anatomy", "reg/loss",
                    "reg/sim", "reg/anatomy",
                    "validation_MindBoggle/seg_dice_avg",
                    "validation_MindBoggle/reg_dice_avg",
                    "validation_MindBoggle/folding_fraction"}
    for s in scalars:
        assert np.isfinite(s["value"]), s
    # 4 iterations per epoch: seg on 0 and 2, reg on 1 and 3
    assert exp.seg_state.step == exp.reg_state.step == 4
    assert [s["step"] for s in scalars if s["tag"] == "seg/loss"] == \
        [2, 4, 6, 8]
    # the multiStep schedule moves both optimizers at each validation
    for state in (exp.seg_state, exp.reg_state):
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(4e-5)
    seg = [s["value"] for s in scalars
           if s["tag"] == "validation_MindBoggle/seg_dice_avg"]
    reg = [s["value"] for s in scalars
           if s["tag"] == "validation_MindBoggle/reg_dice_avg"]
    assert max(seg) == pytest.approx(exp.seg_best_score)
    assert max(reg) == pytest.approx(exp.reg_best_score)
    assert 0.0 < exp.reg_best_score < 1.0


def test_checkpoint_carries_both_nets(trained_experiment):
    exp, _ = trained_experiment
    for name in ("checkpoint", "model_best", "train_config.json"):
        assert os.path.isfile(os.path.join(exp.ckpoint_dir, name))
    state = load_checkpoint(os.path.join(exp.ckpoint_dir, "checkpoint"))
    assert set(state) == {"epoch", "seg_model", "seg_optimizer",
                          "reg_model", "reg_optimizer", "seg_best_score",
                          "reg_best_score", "scheduler"}
    assert state["epoch"] == 2
    assert state["seg_best_score"] == pytest.approx(exp.seg_best_score)
    assert state["reg_best_score"] == pytest.approx(exp.reg_best_score)
    assert state["seg_optimizer"]["state"][0]["step"] == 4
    assert state["reg_optimizer"]["state"][0]["step"] == 4
    for key, model in (("seg_model", exp.seg_model),
                       ("reg_model", exp.reg_model)):
        for k, v in model.state_dict().items():
            assert torch.equal(state[key][k], v), (key, k)
    # BatchNorm statistics travel with the seg net
    assert any(k.endswith("running_var") for k in state["seg_model"])


def test_test_entrypoint_writes_the_log(trained_experiment):
    exp, config = trained_experiment
    seg_pc, seg_avg, reg_pc, reg_avg, folding = \
        DeepAtlasExperiment(config).test(best=True)
    assert seg_pc.shape == reg_pc.shape == (31,)
    assert np.isfinite(seg_avg) and 0.0 <= folding < 1.0
    np.testing.assert_allclose(reg_avg, exp.reg_best_score, atol=1e-5)
    with open(os.path.join(exp.ckpoint_dir, "test_log.txt")) as f:
        log = f.read()
    assert "Testing Model:" in log and "model_best (" in log
    assert f"Seg_Dice_avg: {seg_avg}" in log
    assert f"Reg_Dice_avg: {reg_avg} folding: {folding}" in log


def test_test_falls_back_to_the_periodic_checkpoint(trained_experiment,
                                                    tmp_path):
    exp, config = trained_experiment
    run = tmp_path / "run"
    run.mkdir()
    state = load_checkpoint(os.path.join(exp.ckpoint_dir, "checkpoint"))
    torch.save(state, run / "checkpoint")
    other = DeepAtlasExperiment(config)
    other.ckpoint_dir = str(run)
    result = other.test(best=True, if_log=False)
    assert result[0].shape == (31,)
    assert not (run / "test_log.txt").exists()


def test_resume_continues_at_the_next_epoch(trained_experiment):
    exp, config = trained_experiment
    cfg = dict(config, n_epochs=3,
               resume_dir=os.path.join(exp.ckpoint_dir, "checkpoint"))
    exp3 = DeepAtlasExperiment(cfg)
    with mock.patch.object(exp3, "train_one_epoch",
                           wraps=exp3.train_one_epoch) as epochs:
        exp3.train()                    # runs only epoch 3
    assert epochs.call_count == 1
    assert exp3.current_epoch == 4 and exp3.scheduler.epoch == 3
    assert exp3.seg_best_score >= exp.seg_best_score - 1e-6
    assert exp3.reg_best_score >= exp.reg_best_score - 1e-6
    for state in (exp3.seg_state, exp3.reg_state):
        assert state.optimizer.state_dict()["state"][0]["step"] == 6


def test_unported_config_keys_and_missing_card_raise(corpus):
    config = tiny_config(corpus)
    # the parallel tiers: data_parallel runs at a world of one (its
    # reductions skipped), spatial_shards needs its ranks, the two are
    # exclusive, and the batch must divide by the replicas
    exp = DeepAtlasExperiment({**config, "data_parallel": True})
    assert exp.mesh is not None and exp.mesh.shape == {"data": 1,
                                                       "space": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        DeepAtlasExperiment({**config, "spatial_shards": 2})
    with pytest.raises(ValueError, match="exclusive"):
        DeepAtlasExperiment({**config, "spatial_shards": 2,
                 "data_parallel": True})
    with mock.patch.dict(os.environ, {"WORLD_SIZE": "2"}), \
            pytest.raises(ValueError, match="divisible by 2"):
        DeepAtlasExperiment({**config, "data_parallel": True, "batch_size": 1})
    # the augmenter, image summaries and the seg applies' recompute are
    # ported: accepted
    for key, value in (("augmentation", {"rigid": {}}),
                       ("image_summary", True),
                       ("checkpoint_seg_apply", True)):
        assert DeepAtlasExperiment({**config, key: value}).config[key] \
            == value
    for device in (None, "cuda"):
        with mock.patch.object(torch.cuda, "is_available",
                               return_value=False), \
                pytest.raises(RuntimeError, match="CUDA is not available"):
            DeepAtlasExperiment({**config, "device": device})


def test_epoch_logs_the_experiment_step_and_guard_spans(corpus):
    """Per step one ``experiment.copy_in`` (the pair's four arrays), then
    one ``experiment.step`` that opens with ``step.frozen`` and holds the
    step's ``step.forward`` / ``.loss`` / ``.backward`` (a reg step one
    each in turn; a seg step two forwards and two backwards, ending on a
    backward); ``experiment.log`` once per print period; one
    ``experiment.guard`` per guard action, outside the steps, as many as
    ``guard_actions`` counts."""
    config = tiny_config(corpus, n_epochs=1, overflow_guard={
        "threshold": -1.0, "patience": 1, "mode": "escalate"})
    exp = DeepAtlasExperiment(config)
    exp.setup_train()
    exp._init_state()
    exp._train_iter = endless(exp.training_data_loader)
    t0 = time.perf_counter()
    exp.train_one_epoch()
    spans = [s for s in spans_between(t0, time.perf_counter())
             if not s[0].startswith("data.")]
    exp.close()
    steps = 4
    count = Counter(n for n, _, _ in spans)
    assert exp.guard_actions == steps // 2     # an action every reg step
    assert {k: count[k] for k in ("experiment.copy_in", "experiment.step",
                                  "step.frozen", "experiment.log",
                                  "experiment.guard")} == {
        "experiment.copy_in": steps, "experiment.step": steps,
        "step.frozen": steps, "experiment.log": steps // 2,
        "experiment.guard": exp.guard_actions}
    outer = [s for s in spans if s[0] == "experiment.step"]
    for i, (_, s0, e0) in enumerate(outer):
        inner = [n for n, s, e in spans
                 if n.startswith("step.") and s0 <= s and e <= e0]
        assert inner[0] == "step.frozen", (i, inner)
        kinds = Counter(inner)
        if i % 2:
            assert inner == ["step.frozen", "step.forward", "step.loss",
                             "step.backward"], (i, inner)
        else:
            assert (kinds["step.forward"], kinds["step.backward"]) == (2, 2)
            assert kinds["step.loss"] in (2, 3) and \
                inner[-1] == "step.backward", (i, inner)
    for _, g0, g1 in (s for s in spans if s[0] == "experiment.guard"):
        assert not any(s0 < g1 and g0 < e0 for _, s0, e0 in outer)
    assert count["step.forward"] == 3 * steps // 2


# ----------------------------------------------------------------- guard

def test_guard_matches_jax_on_one_overflow_sequence():
    seq = [0.2] * 9 + [0.01] + [0.2] * 12 + [0.06] * 25 + [None, 0.3]
    for kw in ({}, {"mode": "escalate"}, {"mode": "xla", "patience": 3},
               {"mode": "escalate", "factor": 3, "limit": 20,
                "threshold": 0.1}):
        ours, theirs = DispOverflowGuard(**kw), jax_guard.DispOverflowGuard(
            **kw)
        md = 8
        for ov in seq:
            a, b = ours.update(ov, md), theirs.update(ov, md)
            assert a == b, (kw, ov)
            if a and a["action"] == "escalate":
                md = a["max_disp"]
            assert (ours.count, ours.warned) == (theirs.count, theirs.warned)
    with pytest.raises(ValueError, match="mode"):
        DispOverflowGuard(mode="panic")
    for cfg in ({}, {"overflow_guard": {"patience": 2}},
                {"overflow_guard": False}, {"overflow_guard": True}):
        a = make_guard(cfg, default_mode="escalate")
        b = jax_guard.make_guard(cfg, default_mode="escalate")
        assert (a is None) == (b is None)
        if a is not None:
            assert vars(a) == vars(b)


def test_guard_ladder_matches_the_jax_experiment(corpus):
    """The same overflow sequence through both experiments' guard actions:
    max_disp 8 -> 10 -> unclamped, the last rung turning fused_anatomy and
    hard_fused off; the port rebuilds its steps on the same models."""
    assert deepatlas.LAST_CLAMPED_RUNG == MAX_PACKED_DISP
    config = tiny_config(corpus, max_disp=8)
    config["reg_model_settings"] = dict(config["reg_model_settings"],
                                        max_disp=8)
    ours = DeepAtlasExperiment(config)
    ours.setup_model()
    ours.setup_loss()
    ours._init_state()
    theirs = types.SimpleNamespace(
        config={"max_disp": 8, "use_pallas_warp": True,
                "reg_model_settings": {"max_disp": 8,
                                       "use_pallas_warp": True}},
        overflow_guard=jax_guard.make_guard({}, default_mode="escalate"),
        setup_model=lambda: None, _build_steps=lambda: None,
        seg_model=mock.MagicMock(), reg_model=mock.MagicMock(),
        seg_state=mock.MagicMock(), reg_state=mock.MagicMock())
    steps = (ours.reg_step, ours.seg_step)
    ladder = []
    for _ in range(3):
        for _ in range(10):
            if ours.config["max_disp"] is None:
                break
            act = ours.overflow_guard.update(0.5, ours.config["max_disp"])
            jact = theirs.overflow_guard.update(
                0.5, theirs.config.get("max_disp", 8))
            assert act == jact
            if act:
                ours._apply_guard_action(act)
                jax_deepatlas.DeepAtlasExperiment._apply_guard_action(
                    theirs, jact)
        jc = theirs.config
        clamp = jc["max_disp"] if jc["use_pallas_warp"] else None
        assert ours.config["max_disp"] == clamp
        assert ours.reg_model.max_disp == clamp
        assert ours.config["reg_model_settings"]["max_disp"] == clamp
        for key in ("fused_anatomy", "hard_fused"):
            assert ours.config.get(key, True) == jc.get(key, True)
        ladder.append(clamp)
    assert ladder == [10, None, None]
    assert (ours.reg_step, ours.seg_step) != steps      # rebuilt


# -------------------------------------------------------------------- CLI

def test_cli_runs_every_label_regime_on_the_cpu(corpus, tmp_path,
                                                monkeypatch, capsys):
    """``train_deepatlas_torch.main`` at the recipe's width (UNet_light and
    VoxelMorph in bf16) with 2 of 4 volumes labelled: 42 alternating
    iterations, in which every seg-phase regime and the reg phase's label
    substitution run, one validation, checkpoint and ``test()``."""
    monkeypatch.chdir(tmp_path)
    seen = {"seg": [], "reg": [], "reg_metrics": []}

    def recording(make, phase):
        def factory(*a, **kw):
            step = make(*a, **kw)

            def recorded(state, other, *args):
                seen[phase].append((bool(args[4].all()),
                                    bool(args[5].all())))
                out = step(state, other, *args)
                if phase == "reg":
                    seen["reg_metrics"].append(
                        {k: float(v) for k, v in out[1].items()})
                return out
            return recorded
        return factory

    argv = ["--data-root", str(corpus), "--log-root", "logs",
            "--num-samples", "21", "--num-epochs", "1", "--n-labeled", "2",
            "--max-validation-pairs", "2", "--device", "cpu"]
    with mock.patch.object(deepatlas, "make_joint_seg_step", recording(
            reg_steps.make_joint_seg_step, "seg")), \
            mock.patch.object(deepatlas, "make_joint_reg_step", recording(
                reg_steps.make_joint_reg_step, "reg")):
        seg_pc, seg_avg, reg_pc, reg_avg, folding = \
            train_deepatlas_torch.main(argv)
    assert len(seen["seg"]) == len(seen["reg"]) == 21
    assert set(seen["seg"]) == {(False, False), (False, True), (True, False),
                                (True, True)}
    assert any(not (m and f) for m, f in seen["reg"])
    for m in seen["reg_metrics"]:
        assert set(m) == {"loss", "sim", "reg", "anatomy", "disp_overflow"}
        assert np.all(np.isfinite(list(m.values())))
    assert seg_pc.shape == reg_pc.shape == (31,)
    assert np.isfinite([seg_avg, reg_avg, folding]).all()
    out = capsys.readouterr().out
    assert "Validation: seg dice" in out
    run = tmp_path / "logs" / "MindBoggle" / (
        "DeepAtlas_mindboggle_UNet_light_2labeled_1epochs_lr_0.001") / "230"
    assert (run / "checkpoint").is_file() and (run / "test_log.txt").is_file()
    state = load_checkpoint(str(run / "checkpoint"))
    assert state["seg_optimizer"]["state"][0]["step"] == 21
    assert state["reg_optimizer"]["state"][0]["step"] == 21
    config = json.loads((run / "train_config.json").read_text())
    assert config["crop_size"] == [0, 10, 7, 14, 8, 7]
    assert config["seg_model_settings"]["dtype"] == "bfloat16"
    assert config["reg_model_settings"] == {"max_disp": 8,
                                            "dtype": "bfloat16"}
    assert config["anatomy_weight"] == 3.0 and config["fused_anatomy"]
    assert config["seg_loss_settings"]["eps"] == 1e-6
    again = train_deepatlas_torch.main(argv + ["--test-only"])
    np.testing.assert_allclose(again[3], reg_avg, atol=1e-6)


def test_cli_raises_without_a_card(corpus, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--data-root", str(corpus), "--num-epochs", "1"]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_deepatlas_torch.main(argv)
    with pytest.raises(ValueError, match="21 or 65"):
        train_deepatlas_torch.main(argv + ["--device", "cpu",
                                           "--num-samples", "5"])
    assert not (tmp_path / "logs").exists()
    with pytest.raises(SystemExit):
        train_deepatlas_torch.parse_args(argv + ["--no-packed"])
    # the parallel tiers' flags reach the config
    config = train_deepatlas_torch.build_config(
        train_deepatlas_torch.parse_args(argv + ["--data-parallel",
                                                 "--spatial-shards=2"]))
    assert (config["data_parallel"], config["spatial_shards"]) == (True, 2)


def test_a_jax_joint_checkpoint_crosses(tmp_path):
    """``tools/flax_ckpt_to_torch.py --model deepatlas``: both nets, both
    Adam states, both best scores, epoch and scheduler of a JAX joint
    checkpoint, which the port's experiment then resumes from."""
    from deepatlas_tpu.models import UNetLight as JaxUNetLight
    from deepatlas_tpu.models import VoxelMorphCVPR2018 as JaxVoxelMorph
    from deepatlas_tpu.train import save_checkpoint as jax_save
    from deepatlas_tpu.train.steps import TrainState, make_optimizer
    from deepatlas_torch.models import (UNetLight, VoxelMorphCVPR2018,
                                        unet_from_flax, voxelmorph_from_flax)
    from tools import flax_ckpt_to_torch

    x = jnp.zeros((1, 8, 8, 8, 1), jnp.float32)
    jseg = JaxUNetLight(in_channel=1, n_classes=5, bias=True, BN=True)
    jreg = JaxVoxelMorph()
    sv = jax.jit(jseg.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, train=False)
    rv = jax.jit(jreg.init)(jax.random.PRNGKey(1), x, x)
    states = []
    for model, v in ((jseg, sv), (jreg, rv)):
        st = TrainState.create(apply_fn=model.apply, params=v["params"],
                               batch_stats=v.get("batch_stats", {}),
                               tx=make_optimizer(1e-3))
        states.append(jax.jit(lambda s: s.apply_gradients(
            jax.tree_util.tree_map(lambda p: 0.01 * jnp.ones_like(p),
                                   s.params)))(st))
    seg, reg = states
    jax_save({"epoch": 3, "seg_params": seg.params,
              "seg_batch_stats": seg.batch_stats,
              "seg_opt_state": seg.opt_state, "reg_params": reg.params,
              "reg_opt_state": reg.opt_state, "seg_best_score": 0.5,
              "reg_best_score": 0.25,
              "scheduler": {"lr": 2e-4, "epoch": 3}}, True,
             str(tmp_path / "jax_ckpt"))
    flax_ckpt_to_torch.main(["--ckpt", str(tmp_path / "jax_ckpt" /
                                           "checkpoint"),
                             "--out", str(tmp_path / "torch_ckpt"),
                             "--model", "deepatlas", "--n-classes", "5"])
    restored, epoch, _ = initialize_from(str(tmp_path / "torch_ckpt"))
    assert epoch == 3
    assert (restored["seg_best_score"], restored["reg_best_score"]) == \
        (0.5, 0.25)
    assert restored["scheduler"] == {"lr": pytest.approx(2e-4), "epoch": 3.0}
    useg = UNetLight(in_channel=1, n_classes=5, bias=True, BN=True)
    ureg = VoxelMorphCVPR2018()

    def numpy_tree(t):
        return jax.tree_util.tree_map(np.asarray, jax.device_get(t))

    want_seg = unet_from_flax({"params": numpy_tree(seg.params),
                               "batch_stats": numpy_tree(seg.batch_stats)},
                              useg)
    want_reg = voxelmorph_from_flax({"params": numpy_tree(reg.params)}, ureg)
    for key, want, model in (("seg", want_seg, useg),
                             ("reg", want_reg, ureg)):
        got = restored[f"{key}_model"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (key, k)
        model.load_state_dict(got)
        opt = torch.optim.Adam(model.parameters())
        opt.load_state_dict(restored[f"{key}_optimizer"])
        assert all(float(s["step"]) == 1.0 for s in opt.state.values())
        assert opt.param_groups[0]["lr"] == pytest.approx(1e-3)
