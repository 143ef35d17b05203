"""deepatlas_torch.utils against deepatlas_tpu.utils: ``ParameterDict``
and the JSON round trip across packages (a file written by either reads in
the other, comments included), ``trace`` writing a ``torch.profiler`` trace
under a directory on the CPU, ``annotate`` naming a span in it, and
``device_memory_stats`` empty for the CPU."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from deepatlas_tpu.utils import config as jconfig
from deepatlas_torch.data import write_nifti
from deepatlas_torch.train import segmentation
from deepatlas_torch.utils import (ParameterDict, annotate,
                                   device_memory_stats, load_jason_to_dict,
                                   load_json_to_dict, save_dict_to_json,
                                   trace)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIG = {"model": "UNet", "n_classes": 32, "crop_size": (0, 10, 7),
          "model_settings": {"bias": True, "BN": True}, "lr": 1e-3}


def test_parameter_dict_comments_and_defaults():
    pd = ParameterDict(CONFIG)
    assert pd.set("gamma", 0.2, "lr decay") == 0.2
    assert pd.comment("gamma") == "lr decay" and pd.comment("lr") is None
    assert pd.get_or_default("milestones", [0.5, 1], "of n_epochs") \
        == [0.5, 1]
    assert pd["milestones"] == [0.5, 1]
    assert pd.get_or_default("lr", 5.0) == 1e-3     # present: kept
    assert pd.comment("milestones") == "of n_epochs"
    jpd = jconfig.ParameterDict(CONFIG)
    jpd.set("gamma", 0.2, "lr decay")
    jpd.get_or_default("milestones", [0.5, 1], "of n_epochs")
    assert pd.to_json_obj() == jpd.to_json_obj()
    back = ParameterDict.from_json_obj(pd.to_json_obj())
    assert back == pd and back._comments == pd._comments


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_json_round_trips_across_packages(tmp_path, writer):
    pd = (ParameterDict if writer == "torch" else jconfig.ParameterDict)(
        CONFIG)
    pd.set("gamma", 0.2, "lr decay")
    path = str(tmp_path / "sub" / "train_config.json")
    (save_dict_to_json if writer == "torch"
     else jconfig.save_dict_to_json)(pd, path)
    with open(path) as f:
        raw = json.load(f)
    assert raw["__comments__"] == {"gamma": "lr decay"}
    assert raw["crop_size"] == [0, 10, 7]
    for load in (load_json_to_dict, load_jason_to_dict,
                 jconfig.load_json_to_dict, jconfig.load_jason_to_dict):
        back = load(path)
        assert dict(back) == {k: v for k, v in raw.items()
                              if k != "__comments__"}
        assert back.comment("gamma") == "lr decay"
        assert back["model_settings"] == CONFIG["model_settings"]
        assert back["crop_size"] == [0, 10, 7]
    plain = str(tmp_path / "plain.json")
    save_dict_to_json(dict(CONFIG), plain)
    assert dict(load_json_to_dict(plain)) == dict(
        jconfig.load_json_to_dict(plain))


def test_trace_annotate_and_memory_stats_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        with annotate("experiment.step"):
            torch.ones(64).sum()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "experiment.step" in names
    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(torch.device("cpu")) == {}


def test_seg_experiment_traces_its_second_epoch(tmp_path):
    """``profile_dir``: the seg experiment (here with the fixed UNet on the
    CPU) writes a trace of its second epoch, one ``experiment.step`` span
    per step, as the JAX experiment does."""
    rng = np.random.RandomState(3)
    names = [f"scan{i}" for i in range(2)]
    for sub in ("image_in_MNI152_normalized", "label_31_reID_merged"):
        (tmp_path / sub).mkdir()
    for name in names:
        seg = (rng.rand(8, 8, 8) * 3).astype(np.uint8)
        write_nifti(tmp_path / "image_in_MNI152_normalized"
                    / f"{name}.nii.gz", seg.astype(np.float32) / 3)
        write_nifti(tmp_path / "label_31_reID_merged" / f"{name}.nii.gz",
                    seg)
    (tmp_path / "list.txt").write_text("".join(f"{n}\n" for n in names))
    profile_dir = str(tmp_path / "profile")
    config = dict(
        debug_mode=False, resume_dir="", random_seed=230, data="MindBoggle",
        n_epochs=2, samples_per_epoch=2, batch_size=1, valid_batch_size=1,
        print_batch_period=2, valid_epoch_period=2,
        save_ckpts_epoch_period=2, model="UNet",
        model_settings={"in_channel": 1, "n_classes": 3, "bias": True,
                        "BN": True},
        n_classes=3, loss="dice",
        loss_settings={"n_class": 3, "weight_type": "Uniform",
                       "no_bg": False, "softmax": True, "eps": 1e-6},
        learning_rate=1e-3, lr_mode="const", num_samples=1, device="cpu",
        data_dir=str(tmp_path), training_list_file=str(tmp_path / "list.txt"),
        validation_list_file=str(tmp_path / "list.txt"),
        testing_list_file=str(tmp_path / "list.txt"),
        log_dir=str(tmp_path / "logs"), profile_dir=profile_dir)
    segmentation.SegmentationExperiment(config).train()
    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("name") == "experiment.step"]
    assert len(spans) == 2
