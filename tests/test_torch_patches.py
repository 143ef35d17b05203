"""OAI patch training on the CPU: the crop samplers and the seg experiment
with patches and the device augmenter, against the JAX package.

The samplers are host numpy code on ``np.random.RandomState``: from the
same seed and volumes the port's crops must equal the JAX package's bit for
bit (every start drawn, rejected ones included, and the ``class`` key),
and so must the seg experiment's patch batches (one loader worker: threads
sharing a sampler draw in the order they run, in both packages).  The
experiment slice runs patches plus augmentation for an epoch and writes
the JAX experiment's scalar and image tags, recorded from the JAX
experiment's writer by a stub.
"""
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from deepatlas_tpu.data import endless as jendless
from deepatlas_tpu.data import transforms as jtransforms
from deepatlas_torch.data import transforms as ttransforms
from deepatlas_torch.data import BalancedRandomCrop, RandomCrop, endless
from deepatlas_torch.train import SegmentationExperiment

from tests.test_train import make_mindboggle_corpus, tiny_config

N_DRAWS = 60
AUGMENTATION = {"bspline": {"mesh_size": [3, 3, 3], "deform_scale": 2.0,
                            "ratio": 0.5},
                "rigid": {"rotation_angles": [5, 5, 5],
                          "translation": [2, 2, 2], "ratio": 0.5,
                          "mode": "both"},
                "blur": {"sigma": 0.7, "ratio": 0.3}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sample(seed, shape=(20, 18, 22), n_classes=3, with_seg=True):
    """A volume whose labels 1..n_classes-1 fill blocks of different sizes
    (class 1 common, the last class rare)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros(shape, np.uint8)
    d, h, w = shape
    seg[2:d // 2, 3:h - 3, 1:w // 2] = 1
    seg[d - 6:d - 2, h - 5:h - 1, w - 5:w - 1] = n_classes - 1
    out = {"image": rng.rand(*shape, 1).astype(np.float32), "name": "v"}
    if with_seg:
        out["segmentation"] = seg
    return out


def draws(sampler, samples):
    """Each call's crops and every start it drew (``_crop_at``'s second
    argument), in order."""
    starts, outs = [], []
    with mock.patch.object(sampler, "_crop_at",
                           wraps=sampler._crop_at) as spy:
        for s in samples:
            spy.reset_mock()
            outs.append(sampler(s))
            starts.append([list(c.args[1]) for c in spy.call_args_list])
    return starts, outs


def assert_same_draws(ours, theirs, samples):
    our_starts, our_outs = draws(ours, samples)
    their_starts, their_outs = draws(theirs, samples)
    assert our_starts == their_starts
    for a, b in zip(our_outs, their_outs):
        assert set(a) == set(b)
        assert a.get("class") == b.get("class")
        np.testing.assert_array_equal(a["image"], b["image"])
        if "segmentation" in b:
            np.testing.assert_array_equal(a["segmentation"],
                                          b["segmentation"])
    # the generators consumed the same numbers
    np.testing.assert_array_equal(ours.rng.get_state()[1],
                                  theirs.rng.get_state()[1])
    return our_starts, our_outs


def test_rand_start_never_draws_the_last_position():
    rng = np.random.RandomState(0)
    assert {ttransforms._rand_start(rng, 3) for _ in range(200)} == {0, 1, 2}
    assert ttransforms._rand_start(rng, 0) == 0


@pytest.mark.parametrize("size,threshold,max_tries,with_seg", [
    (8, 0.0, 100, True),                  # first draw always
    ((8, 6, 10), 0.35, 100, True),        # some draws rejected
    ((8, 8, 8), 2.0, 7, True),            # never met: all tries spent
    ((20, 9, 4), 0.2, 100, True),         # no freedom along D
    (8, 0.5, 100, False),                 # no labels: first draw
])
def test_random_crop_draws_like_jax(size, threshold, max_tries, with_seg):
    samples = [sample(i, with_seg=with_seg) for i in range(N_DRAWS)]
    ours = RandomCrop(size, threshold, np.random.RandomState(230), max_tries)
    theirs = jtransforms.RandomCrop(size, threshold,
                                    np.random.RandomState(230), max_tries)
    starts, outs = assert_same_draws(ours, theirs, samples)
    shape = (size,) * 3 if isinstance(size, int) else size
    assert all(o["image"].shape == shape + (1,) for o in outs)
    if threshold > 1:
        # the last crop is returned though it is below the threshold
        assert all(len(s) == max_tries for s in starts)


@pytest.mark.parametrize("threshold,n_classes", [
    (0.01, 3), (0.2, 3), ((0.05, 0.3, 0.01), 3), (0.01, 2)])
def test_balanced_crop_draws_like_jax(threshold, n_classes):
    samples = [sample(i, n_classes=n_classes) for i in range(N_DRAWS)]
    ours = BalancedRandomCrop(8, threshold, n_classes,
                              np.random.RandomState(230))
    theirs = jtransforms.BalancedRandomCrop(8, threshold, n_classes,
                                            np.random.RandomState(230))
    starts, outs = assert_same_draws(ours, theirs, samples)
    classes = [o["class"] for o in outs]
    # from min(2, n_classes - 1), cycling through 0..n_classes inclusive
    first = min(2, n_classes - 1)
    cycle = list(range(n_classes + 1))
    assert classes == [cycle[(first + i) % len(cycle)]
                       for i in range(N_DRAWS)]
    # class n_classes is in no mask: every one of its 100 tries is spent;
    # class 0 takes its first draw
    for c, s in zip(classes, starts):
        if c == n_classes:
            assert len(s) == 100
        if c == 0:
            assert len(s) == 1


def patch_config(root, sampler, **over):
    """The JAX package's ``test_patch_sampler_config`` setup, with one
    loader worker."""
    config = tiny_config(root, n_epochs=1)
    config.update(patch_size=(8, 8, 8), sampler=sampler, crop_size=None,
                  samples_per_epoch=2, num_workers=1)
    config.update(over)
    return config


@pytest.mark.parametrize("sampler,threshold", [("balanced", None),
                                               ("random", None),
                                               ("random", 0.2)])
def test_experiment_patch_batches_match_jax(tmp_path, sampler, threshold):
    from deepatlas_tpu.train import \
        SegmentationExperiment as JaxSegmentationExperiment

    make_mindboggle_corpus(tmp_path, shape=(16, 16, 16))
    over = {} if threshold is None else {"patch_threshold": threshold}
    config = patch_config(tmp_path, sampler, **over)
    theirs = JaxSegmentationExperiment(dict(config))
    theirs.setup_train_data()
    ours = SegmentationExperiment(dict(config, device="cpu"))
    ours.setup_train_data()
    want_cls = BalancedRandomCrop if sampler == "balanced" else RandomCrop
    ours_tf = ours.training_data_loader.dataset.running_transform
    theirs_tf = theirs.training_data_loader.dataset.running_transform
    assert type(ours_tf) is want_cls
    assert type(theirs_tf).__name__ == want_cls.__name__
    assert ours_tf.size == theirs_tf.size == (8, 8, 8)
    assert getattr(ours_tf, "threshold", None) == \
        getattr(theirs_tf, "threshold", None)
    assert getattr(ours_tf, "thresholds", None) == \
        getattr(theirs_tf, "thresholds", None)
    our_iter = endless(ours.training_data_loader)
    their_iter = jendless(theirs.training_data_loader)
    classes = []
    for _ in range(12):             # three passes over the 4 volumes
        a, b = next(our_iter), next(their_iter)
        assert a["name"] == b["name"]
        assert a["image"].shape == (1, 8, 8, 8, 1)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert a.get("class") == b.get("class")
        classes += a.get("class", [])
    if sampler == "balanced":
        assert classes == [2, 3, 0, 1] * 3


def read_scalars(exp):
    with open(os.path.join(exp.ckpoint_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


class WriterStub:
    """Records what an experiment writes: (kind, tag, step[, shape])."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, global_step=None):
        self.calls.append(("scalar", tag, int(global_step)))

    def add_image(self, tag, img, global_step=None):
        self.calls.append(("image", tag, int(global_step),
                           tuple(np.shape(img))))

    def close(self):
        pass


def jax_writes(experiment_cls, config):
    """Train the JAX experiment with a stub for its TensorBoard writer;
    returns the stub's calls."""
    exp = experiment_cls(config)
    stub = WriterStub()

    def setup_log():
        os.makedirs(exp.ckpoint_dir, exist_ok=True)
        exp.writer = stub

    exp.setup_log = setup_log
    exp.train()
    return stub.calls


def port_writes(exp):
    """The port experiment's writes from its files, in the stub's form."""
    calls = [("scalar", s["tag"], s["step"]) for s in read_scalars(exp)]
    root = os.path.join(exp.ckpoint_dir, "images")
    for tag_dir in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, tag_dir))):
            img = np.load(os.path.join(root, tag_dir, name))
            assert img.dtype == np.float32
            assert 0.0 <= img.min() and img.max() <= 1.0
            calls.append(("image", tag_dir.replace("__", "/"),
                          int(name[:-4]), img.shape))
    return calls


def test_patch_training_with_augmentation_runs_and_writes_jax_tags(tmp_path):
    """The seg experiment on 8^3 balanced patches with B-spline, rigid and
    blur augmentation: finite losses, the training and validation image
    summaries, and the JAX experiment's scalar and image tags, steps and
    image shapes."""
    from deepatlas_tpu.train import \
        SegmentationExperiment as JaxSegmentationExperiment

    make_mindboggle_corpus(tmp_path, shape=(16, 16, 16))
    config = patch_config(tmp_path, "balanced", augmentation=AUGMENTATION,
                          samples_per_epoch=4, print_batch_period=2)
    want = jax_writes(JaxSegmentationExperiment,
                      dict(config, log_dir=str(tmp_path / "jax_logs")))
    exp = SegmentationExperiment(dict(config, device="cpu"))
    losses = []
    step = SegmentationExperiment._init_state

    def init_state(self):
        step(self)
        train_step = self.train_step

        def recorded(state, images, labels):
            assert images.shape == (1, 8, 8, 8, 1)
            out = train_step(state, images, labels)
            losses.append(float(out[1]))
            return out
        self.train_step = recorded

    with mock.patch.object(SegmentationExperiment, "_init_state",
                           init_state):
        exp.train()
    assert exp.augmenter is not None
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    got = port_writes(exp)
    assert sorted(got) == sorted(want)
    assert {c[1] for c in got if c[0] == "image"} == {"training",
                                                      "validation"}
