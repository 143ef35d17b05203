"""deepatlas_torch sliding-window inference against the JAX package's.

One UNet_light (randomized JAX standard variables, converted to the port)
labels a 20x28x24 volume in 16^3 tiles with overlap 4 through both
packages' ``sliding_window_predict``.  The two networks agree to float32
rounding, so a label may differ only where the JAX logits' top-2 margin is
below 1e-4; such voxels take the JAX label and the assembled volumes must
then be identical, in center-stitch and in vote mode.
"""
import time
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepatlas_tpu.metrics.confusion import (
    confusion_matrix as jax_confusion, dice_from_confusion as jax_dice)
from deepatlas_tpu.models import UNetLight as JaxUNetLight
from deepatlas_tpu.train.inference import (
    evaluate_sliding_window as jax_evaluate,
    make_tile_predictor as jax_tile_predictor,
    sliding_window_predict as jax_sliding_window)
from deepatlas_torch.data import Partition
from deepatlas_torch.metrics import confusion_matrix, dice_from_confusion
from deepatlas_torch.models import UNetLight, unet_from_flax
from deepatlas_torch.train import (evaluate_sliding_window,
                                   make_tile_predictor,
                                   sliding_window_predict)
from deepatlas_torch.utils import spans_between
from tests.test_torch_unet import randomize

NC = 4
TILE, OVERLAP, BATCH = (16, 16, 16), (4, 4, 4), 4
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several pytest-xdist workers at once; torch's
    default of one intra-op thread per core would oversubscribe the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(230)
    vol = rng.rand(20, 28, 24, 1).astype(np.float32)
    jax_model = JaxUNetLight(in_channel=1, n_classes=NC, bias=True, BN=True)
    variables = jax.jit(jax_model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1,) + TILE + (1,)), train=False)
    variables = randomize(dict(variables), rng)
    model = UNetLight(in_channel=1, n_classes=NC, bias=True, BN=True).eval()
    model.load_state_dict(unet_from_flax(variables, model))
    fwd = jax.jit(lambda t: jax_model.apply(variables, t, train=False))
    return vol, jax_model, variables, model, fwd


def checked_predictor(model, fwd):
    """The port's tile predictor, with each label held to the JAX logits."""
    predict = make_tile_predictor(model, BATCH)

    def run(tiles):
        labels = predict(tiles)
        logits = np.concatenate([np.asarray(fwd(jnp.asarray(
            tiles[i:i + BATCH]))) for i in range(0, len(tiles), BATCH)])
        top2 = np.sort(logits, axis=-1)[..., -2:]
        close = top2[..., 1] - top2[..., 0] < MARGIN
        ref = logits.argmax(-1)
        assert not ((labels != ref) & ~close).any()
        return np.where(close, ref, labels).astype(np.uint8)

    return run


@pytest.mark.parametrize("vote", [False, True])
def test_sliding_window_matches_jax(setup, vote):
    vol, jax_model, variables, model, fwd = setup
    ref = jax_sliding_window(
        jax_tile_predictor(jax_model.apply, variables, BATCH),
        {"image": vol}, TILE, OVERLAP, is_vote=vote)
    out = sliding_window_predict(checked_predictor(model, fwd),
                                 {"image": vol}, TILE, OVERLAP, is_vote=vote)
    assert out.dtype == np.uint8 and out.shape == vol.shape[:3]
    np.testing.assert_array_equal(out, ref)


def test_evaluate_sliding_window_matches_jax(setup):
    vol, jax_model, variables, model, _ = setup
    truth = np.random.RandomState(1).randint(0, NC, vol.shape[:3]) \
        .astype(np.uint8)
    batches = [{"image": vol[None], "segmentation": truth[None],
                "name": ["v0"]}]
    ref, ref_names = jax_evaluate(jax_model.apply, variables, batches, TILE,
                                  OVERLAP, NC, tile_batch=BATCH)
    out, names = evaluate_sliding_window(model, batches, TILE, OVERLAP, NC,
                                         tile_batch=BATCH)
    assert names == ref_names and out.shape == (1, NC - 1)
    # labels may differ only at near-tie voxels: a few of 13440
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_tiling_spans_per_volume_and_per_tile_batch(setup):
    """Two volumes: one ``tiling.pad``, ``.cut`` and ``.stitch`` each, and
    one ``tiling.copy_in``, ``.predict`` and ``.copy_out`` per tile
    batch."""
    vol, _, _, model, _ = setup
    n_tiles = len(Partition(TILE, OVERLAP)({"image": vol})["image"])
    batches = -(-n_tiles // BATCH)
    predict = make_tile_predictor(model, BATCH)
    t0 = time.perf_counter()
    for _ in range(2):
        sliding_window_predict(predict, {"image": vol}, TILE, OVERLAP)
    spans = spans_between(t0, time.perf_counter())
    assert Counter(n for n, _, _ in spans if n.startswith("tiling.")) == {
        "tiling.pad": 2, "tiling.cut": 2, "tiling.stitch": 2,
        "tiling.copy_in": 2 * batches, "tiling.predict": 2 * batches,
        "tiling.copy_out": 2 * batches}
    order = [n for n, _, _ in spans if n.startswith("tiling.")]
    assert order[:3] == ["tiling.pad", "tiling.cut", "tiling.copy_in"]
    assert order[-1] == "tiling.stitch"


def test_tile_predictor_pads_ragged_chunks(setup):
    _, _, _, model, _ = setup
    tiles = np.random.RandomState(2).rand(5, *TILE, 1).astype(np.float32)
    out = make_tile_predictor(model, BATCH)(tiles)
    assert out.shape == (5,) + TILE and out.dtype == np.uint8
    with torch.inference_mode():
        ref = model(torch.from_numpy(tiles)).argmax(-1).numpy()
    np.testing.assert_array_equal(out, ref)


def test_confusion_and_dice_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.randint(0, 5, (9, 10, 11))
    truth = rng.randint(0, 5, (9, 10, 11))
    truth[truth == 3] = 0                   # a class absent from truth
    cm = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(truth), 5)
    ref = jax_confusion(jnp.asarray(pred), jnp.asarray(truth), 5)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(ref))
    np.testing.assert_allclose(dice_from_confusion(cm, 1e-11).numpy(),
                               np.asarray(jax_dice(ref, 1e-11)), rtol=1e-6)
