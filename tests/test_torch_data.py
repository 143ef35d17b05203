"""deepatlas_torch data path and CLI against the JAX package's.

NIfTI files written by one package read back identically in the other,
``Partition`` cuts and assembles exactly as the JAX one does,
``infer_seg_torch.py --device cpu`` prints the same JSON lines as
``infer_seg.py`` on a checkpoint converted by ``tools/flax_ckpt_to_torch.py``,
the loader gives each iterator its own buffers, and importing the port
pulls in neither JAX nor the JAX package.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.data.nifti import read_nifti as jax_read_nifti
from deepatlas_tpu.data.nifti import write_nifti as jax_write_nifti
from deepatlas_tpu.data.transforms import Partition as JaxPartition
from deepatlas_torch.data import DataLoader, Partition, read_nifti, write_nifti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,suffix", [(np.float32, ".nii.gz"),
                                          (np.uint8, ".nii"),
                                          (np.int16, ".nii.gz")])
def test_nifti_round_trips_with_jax(tmp_path, rng, dtype, suffix):
    data = (rng.rand(5, 7, 6) * 100).astype(dtype)
    affine = np.diag([0.7, 0.36, 0.36, 1.0])
    affine[:3, 3] = [1.5, -2.0, 3.25]
    from deepatlas_torch.data import NiftiImage
    image = NiftiImage(data, spacing=(0.7, 0.36, 0.36), affine=affine)

    ours = tmp_path / f"ours{suffix}"
    write_nifti(ours, image)
    for prefer_native in (False, True):
        back = jax_read_nifti(ours, prefer_native=prefer_native)
        np.testing.assert_array_equal(back.data, data)
        # (the JAX package's native reader hands back float32 volumes)
        assert prefer_native or back.data.dtype == data.dtype
        np.testing.assert_allclose(back.spacing, image.spacing, rtol=1e-6)
        np.testing.assert_allclose(back.affine, affine, rtol=1e-6)

    theirs = tmp_path / f"theirs{suffix}"
    jax_write_nifti(theirs, data)
    back = read_nifti(theirs)
    np.testing.assert_array_equal(back.data, data)
    ref = jax_read_nifti(theirs, prefer_native=False)
    assert back.spacing == ref.spacing
    np.testing.assert_array_equal(back.affine, ref.affine)


def test_partition_and_assemble_match_jax(rng):
    vol = rng.rand(20, 18, 16, 1).astype(np.float32)
    ours, theirs = Partition((12, 12, 12), (2, 2, 2)), \
        JaxPartition((12, 12, 12), (2, 2, 2))
    tiles = ours({"image": vol})["image"]
    np.testing.assert_array_equal(tiles, theirs({"image": vol})["image"])
    labels = rng.randint(0, 4, tiles.shape[:4]).astype(np.uint8)
    for kw in ({}, {"is_vote": True}, {"crop_size": (2, 3, 1)},
               {"is_vote": True, "data_type": np.uint8}):
        np.testing.assert_array_equal(ours.assemble(labels, **kw),
                                      theirs.assemble(labels, **kw))
    # a label volume survives the round trip
    seg = rng.randint(0, 5, vol.shape[:3]).astype(np.uint8)
    back = ours.assemble(ours({"image": seg.astype(np.float32)})["image"][
        ..., 0].astype(np.uint8))
    np.testing.assert_array_equal(back, seg)


def write_oai_corpus(root, rng, shape=(24, 24, 24)):
    names = ["k0_RIGHT", "k1_LEFT"]
    for name in names:
        seg = np.zeros(shape, np.uint8)
        seg[4:12, 6:14, 5:15] = 1
        seg[12:20, 10:18, 8:16] = 2
        img = seg / 3.0 + 0.1 * rng.rand(*shape)
        write_nifti(root / f"{name}_image.nii.gz", img.astype(np.float32))
        write_nifti(root / f"{name}_masks.nii.gz", seg)
    (root / "test.txt").write_text("".join(f"{n}\n" for n in names))


def run_cli(main, argv, capsys):
    capsys.readouterr()
    main(argv)
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_infer_seg_torch_cli_matches_infer_seg(tmp_path, rng, capsys,
                                               monkeypatch):
    """A JAX checkpoint -> tools/flax_ckpt_to_torch.py -> the port's CLI
    prints the same lines (keys, names, Dice within near-tie label flips)
    as infer_seg.py on the original checkpoint."""
    import infer_seg
    import infer_seg_torch
    from deepatlas_tpu.models import UNetLight as JaxUNetLight
    from deepatlas_tpu.train import save_checkpoint as jax_save
    from tests.test_torch_unet import randomize
    from tools import flax_ckpt_to_torch

    write_oai_corpus(tmp_path, rng)
    # infer_seg.py initializes its model eagerly before restoring every
    # value from the checkpoint; zero kernels instead of truncated-normal
    # draws spare ~20 s of per-op compiles and change no restored value
    from flax import linen as nn

    from deepatlas_tpu.models import layers, unet
    for mod in (layers, unet):
        monkeypatch.setattr(mod, "conv_kernel_init", nn.initializers.zeros)
    model = JaxUNetLight(in_channel=1, n_classes=3, bias=True, BN=True)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)), train=False)
    variables = randomize(dict(variables), rng)
    jax_save({"epoch": 3, "best_score": 0.5, "params": variables["params"],
              "batch_stats": variables["batch_stats"], "opt_state": None},
             True, str(tmp_path / "jax_ckpt"))
    common = ["--data-root", str(tmp_path), "--list-file",
              str(tmp_path / "test.txt"), "--data", "OAI", "--n-classes", "3",
              "--tile-size", "16", "16", "16", "--overlap", "4", "4", "4",
              "--tile-batch", "2", "--no-bf16", "--flip-left"]

    monkeypatch.setattr(sys, "argv", ["infer_seg.py", "--ckpt",
                                      str(tmp_path / "jax_ckpt" / "model_best"),
                                      "--no-packed", *common])
    ref = run_cli(lambda argv: infer_seg.main(), None, capsys)

    flax_ckpt_to_torch.main(["--ckpt", str(tmp_path / "jax_ckpt" / "model_best"),
                             "--out", str(tmp_path / "torch_ckpt"),
                             "--n-classes", "3"])
    from deepatlas_torch.train import load_checkpoint
    state = load_checkpoint(str(tmp_path / "torch_ckpt" / "model_best"))
    assert (state["epoch"], state["best_score"]) == (3, 0.5)

    out = run_cli(infer_seg_torch.main,
                  ["--ckpt", str(tmp_path / "torch_ckpt" / "model_best"),
                   "--device", "cpu", *common], capsys)
    assert [sorted(ln) for ln in out] == [sorted(ln) for ln in ref]
    assert [ln.get("name") for ln in out] == ["k0_RIGHT", "k1_LEFT", None]
    for a, b in zip(out, ref):
        for key in ("dice", "dice_avg", "mean_dice_per_class",
                    "mean_dice_avg"):
            if key in a:
                np.testing.assert_allclose(a[key], b[key], atol=2e-3)


def test_infer_seg_torch_rejects_spatial_shards_and_missing_cuda(tmp_path):
    import infer_seg_torch

    with pytest.raises(SystemExit):
        infer_seg_torch.parse_args(["--ckpt", "x", "--data-root", "x",
                                    "--list-file", "x", "--n-classes", "2",
                                    "--spatial-shards", "2"])
    from deepatlas_torch import resolve_device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


class _Samples:
    def __init__(self, n):
        self.items = [{"image": np.full((4, 4), i, np.float32),
                       "name": f"s{i}"} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return dict(self.items[i])


def test_loader_iterators_own_their_buffers():
    loader = DataLoader(_Samples(6), batch_size=1, prefetch=2, num_workers=0)
    baseline = threading.active_count()
    first = iter(loader)
    a = [next(first) for _ in range(2)]
    second = iter(loader)
    b = [next(second) for _ in range(2)]
    for x in a:
        for y in b:
            assert not np.shares_memory(x["image"], y["image"])
    assert [x["name"] for x in b] == [["s0"], ["s1"]]
    np.testing.assert_array_equal(b[1]["image"], np.full((1, 4, 4), 1.0))
    first.close()             # an abandoned iterator stops its producer
    second.close()
    assert threading.active_count() == baseline
    assert [x["name"][0] for x in loader] == [f"s{i}" for i in range(6)]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepatlas_torch\n"
        "for m in pkgutil.walk_packages(deepatlas_torch.__path__,"
        " 'deepatlas_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import infer_seg_torch, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'orbax', 'deepatlas_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
