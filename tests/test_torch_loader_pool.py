"""The loader's decode pool.

Its default size comes from the CPUs the process may use (affinity mask and
cgroup quota, less the step thread and the producer, 2..16); a dataset with
a ``running_transform`` keeps the batch-sized count, since its crops draw
from one random state the threads share; an explicit ``num_workers`` wins.
The batches are the same at every pool size, the in-flight window keeps
every thread reading, across epoch boundaries too under ``endless``, and
``decode_seconds`` sums the reads' durations.
"""
import random
import sys
import threading
import time
import types

import numpy as np
import pytest

from deepatlas_tpu.data import DataLoader as JaxDataLoader
from deepatlas_tpu.data import endless as jax_endless
from deepatlas_torch.data import (BalancedRandomCrop, DataLoader, NiftiImage,
                                  RandomCrop, endless, write_nifti)
from deepatlas_torch.data import datasets
from deepatlas_torch.data import loader as loader_mod
from deepatlas_torch.data.loader import (auto_num_workers, host_num_workers,
                                         usable_cpus)
from deepatlas_torch.train import SegmentationExperiment


@pytest.fixture
def cpus(monkeypatch):
    """Fake the host: ``cpus(n, quota)`` gives the process an affinity mask
    of ``n`` CPUs and a cgroup quota of ``quota`` CPUs (None: no quota), as
    the one rank on its host."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)

    def fake(n, quota=None):
        monkeypatch.setattr(loader_mod.os, "sched_getaffinity",
                            lambda pid: set(range(n)))
        monkeypatch.setattr(loader_mod, "_cgroup_cpu_quota", lambda: quota)
    return fake


class _Volumes:
    """Index-derived samples; each read sleeps a random moment, so the
    pool's reads finish out of order."""

    def __init__(self, n, sleep=0.002):
        self.n, self.sleep = n, sleep

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.sleep:
            time.sleep(random.random() * self.sleep)
        image = np.arange(60, dtype=np.float32).reshape(3, 4, 5) + 100 * i
        return {"image": image, "segmentation": (image % 7).astype(np.uint8),
                "name": f"v{i}"}


def _batches(loader):
    """Every batch of one epoch, copied out of the loader's buffer ring."""
    return [{k: v.copy() if isinstance(v, np.ndarray) else v
             for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("n,want", [(1, 2), (4, 2), (8, 6), (64, 16)])
def test_default_pool_follows_the_affinity_mask(cpus, n, want):
    cpus(n)
    assert usable_cpus() == n
    assert host_num_workers() == want
    assert DataLoader(_Volumes(4), batch_size=1).num_workers == want
    # the batch no longer sizes it
    assert DataLoader(_Volumes(4), batch_size=8).num_workers == want


@pytest.mark.parametrize("quota,want_cpus,want", [(3.5, 3, 2), (8.0, 8, 6),
                                                  (0.5, 1, 2), (None, 64, 16)])
def test_cgroup_quota_cuts_the_pool(cpus, quota, want_cpus, want):
    cpus(64, quota)
    assert usable_cpus() == want_cpus
    assert host_num_workers() == want


@pytest.mark.parametrize("proc,files,quota", [
    # the namespace's root (a container with its own cgroup namespace)
    ("0::/\n", {"cpu.max": "350000 100000\n"}, 3.5),
    ("0::/\n", {"cpu.max": "max 100000\n"}, None),
    ("2:cpu,cpuacct:/\n0::/\n",
     {"cpu/cpu.cfs_quota_us": "400000\n", "cpu/cpu.cfs_period_us": "100000\n"},
     4.0),
    ("2:cpu,cpuacct:/\n0::/\n",
     {"cpu/cpu.cfs_quota_us": "-1\n", "cpu/cpu.cfs_period_us": "100000\n"},
     None),
    ("0::/\n", {}, None),
    # no namespace: the process's own cgroup, and the smallest quota of
    # those above it (a systemd slice, a batch job's step)
    ("0::/system.slice/job.scope\n",
     {"system.slice/job.scope/cpu.max": "200000 100000\n",
      "system.slice/cpu.max": "max 100000\n"}, 2.0),
    ("0::/system.slice/job.scope\n",
     {"system.slice/job.scope/cpu.max": "max 100000\n",
      "system.slice/cpu.max": "150000 100000\n"}, 1.5),
    ("4:cpu,cpuacct:/slurm/job1/step0\n0::/\n",
     {"cpu/slurm/job1/step0/cpu.cfs_quota_us": "-1\n",
      "cpu/slurm/job1/step0/cpu.cfs_period_us": "100000\n",
      "cpu/slurm/job1/cpu.cfs_quota_us": "600000\n",
      "cpu/slurm/job1/cpu.cfs_period_us": "100000\n"}, 6.0),
    # a cgroup the mount does not show: the mount's own quota
    ("0::/docker/abc\n", {"cpu.max": "300000 100000\n"}, 3.0),
    # no cgroup file: v2 at the root
    (None, {"cpu.max": "250000 100000\n"}, 2.5),
])
def test_cgroup_quota_is_read_from_v2_or_v1(tmp_path, proc, files, quota):
    root = tmp_path / "cgroup"
    root.mkdir()
    for name, text in files.items():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    proc_file = tmp_path / "proc_self_cgroup"
    if proc is not None:
        proc_file.write_text(proc)
    assert loader_mod._cgroup_cpu_quota(str(root), str(proc_file)) == quota


@pytest.mark.parametrize("ranks,n,want", [(None, 32, 16), ("1", 32, 16),
                                          ("4", 32, 6), ("4", 64, 14),
                                          ("4", 8, 2), ("8", 32, 2)])
def test_ranks_on_one_host_share_the_cpus(cpus, monkeypatch, ranks, n, want):
    """Under torchrun every rank of a host builds its own loader and pool,
    so each takes its share of the usable CPUs less its own two threads."""
    cpus(n)
    if ranks is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", ranks)
    assert host_num_workers() == want
    assert DataLoader(_Volumes(4), batch_size=1).num_workers == want


def test_explicit_num_workers_wins(cpus, tmp_path):
    cpus(64)
    assert DataLoader(_Volumes(4), num_workers=3).num_workers == 3
    assert DataLoader(_Volumes(4), num_workers=0).num_workers == 0
    ds = _dataset(datasets.SegDataSetMindBoggle, tmp_path,
                  RandomCrop((2, 2, 2)))
    assert DataLoader(ds, num_workers=5).num_workers == 5


def _dataset(cls, root, running_transform=None):
    """A dataset over a list of names whose files are never read."""
    (root / "list.txt").write_text("a\nb\nc\n")
    return cls(str(root / "list.txt"), str(root),
               running_transform=running_transform)


DATASET_CLASSES = sorted({*datasets._SEG.values(), *datasets._REG.values(),
                          datasets.SegDataset}, key=lambda c: c.__name__)


@pytest.mark.parametrize("cls", DATASET_CLASSES, ids=lambda c: c.__name__)
def test_every_dataset_class_takes_its_path(cpus, tmp_path, cls):
    """No running transform: the host's pool; with one (the patch
    samplers), ``auto_num_workers(batch_size)``, as before."""
    cpus(64)
    assert DataLoader(_dataset(cls, tmp_path), batch_size=1).num_workers == 16
    rng = np.random.RandomState(0)
    for sampler in (RandomCrop((2, 2, 2), random_state=rng),
                    BalancedRandomCrop((2, 2, 2), n_classes=3,
                                       random_state=rng)):
        ds = _dataset(cls, tmp_path, sampler)
        assert DataLoader(ds, batch_size=1).num_workers \
            == auto_num_workers(1) == 2
        assert DataLoader(ds, batch_size=4).num_workers == auto_num_workers(4)


def _experiment_config(root, **over):
    img_dir = root / "image_in_MNI152_normalized"
    seg_dir = root / "label_31_reID_merged"
    img_dir.mkdir(parents=True)
    seg_dir.mkdir(parents=True)
    for name in ("s0", "s1"):
        write_nifti(img_dir / f"{name}.nii.gz",
                    NiftiImage(np.zeros((8, 8, 8), np.float32)))
        write_nifti(seg_dir / f"{name}.nii.gz",
                    NiftiImage(np.zeros((8, 8, 8), np.uint8)))
    (root / "list.txt").write_text("s0\ns1\n")
    config = dict(
        debug_mode=False, resume_dir="", random_seed=230, data="MindBoggle",
        n_epochs=1, samples_per_epoch=2, batch_size=1, n_classes=3,
        model="UNet_light", model_settings={}, loss="dice",
        loss_settings={"weight_type": "Uniform"}, learning_rate=1e-2,
        lr_mode="const",
        num_samples=2, preload=False, device="cpu", data_dir=str(root),
        training_list_file=str(root / "list.txt"),
        validation_list_file=str(root / "list.txt"),
        log_dir=str(root / "logs"))
    config.update(over)
    return config


@pytest.mark.parametrize("over,want", [
    ({}, 16),
    ({"patch_size": (4, 4, 4), "sampler": "balanced"}, 2),
    ({"patch_size": (4, 4, 4), "sampler": "random"}, 2),
    ({"patch_size": (4, 4, 4), "num_workers": 1}, 1),
])
def test_seg_experiment_prints_its_pool(cpus, tmp_path, capsys, over, want):
    """The seg experiment's patch samplers keep the 2-thread class cycle of
    ``BalancedRandomCrop`` (``tests/test_torch_patches.py`` holds its draws
    against the JAX package's)."""
    cpus(64)
    exp = SegmentationExperiment(_experiment_config(tmp_path, **over))
    exp.setup_train_data()
    assert exp.training_data_loader.num_workers == want
    assert f"Initializing dataloader: {want} decode threads" \
        in capsys.readouterr().out


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_are_alike_at_every_pool_size(cpus, prefetch):
    cpus(64)
    sizes = [1, 2, host_num_workers(), DataLoader(_Volumes(1)).num_workers]
    assert sizes[2:] == [16, 16]
    runs = [_batches(DataLoader(_Volumes(13), batch_size=2, shuffle=True,
                                drop_last=False, seed=5, prefetch=prefetch,
                                num_workers=n)) for n in sizes]
    order = [b["name"] for b in runs[0]]
    assert len(order) == 7 and sorted(sum(order, [])) \
        == sorted(f"v{i}" for i in range(13))
    for run in runs[1:]:
        assert [b["name"] for b in run] == order
        for a, b in zip(runs[0], run):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["segmentation"],
                                          b["segmentation"])


class _Rendezvous(_Volumes):
    """Each read waits until ``parties`` reads are in flight at once."""

    def __init__(self, n, parties):
        super().__init__(n, sleep=0)
        self.barrier = threading.Barrier(parties, timeout=20)

    def __getitem__(self, i):
        self.barrier.wait()
        return super().__getitem__(i)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_window_keeps_every_thread_reading(cpus, batch_size):
    """The in-flight window (pool size plus the prefetched batches) hands
    every thread of the host-sized pool a read: a window smaller than the
    pool would leave the barrier short of its parties."""
    cpus(64)
    loader = DataLoader(_Rendezvous(48, 16), batch_size=batch_size)
    assert loader.num_workers == 16
    assert len(list(loader)) == 48 // batch_size


@pytest.mark.parametrize("workers,prefetch", [(0, 0), (1, 2), (2, 2),
                                              (16, 2), (16, 0)])
def test_endless_gives_the_epochs_in_turn(workers, prefetch):
    """``endless`` yields what iterating the loader again and again yields:
    each epoch reshuffled, the trailing partial batch kept."""
    def loader(**kw):
        return DataLoader(_Volumes(7), batch_size=2, shuffle=True, seed=5,
                          drop_last=False, **kw)

    reference = loader(num_workers=1, prefetch=0)
    want = [b for _ in range(4) for b in _batches(reference)]
    it = endless(loader(num_workers=workers, prefetch=prefetch))
    got = [{k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in next(it).items()} for _ in range(len(want))]
    it.close()
    assert len(want) == 16
    assert [b["name"] for b in got] == [b["name"] for b in want]
    assert [b["name"] for b in want[:4]] != [b["name"] for b in want[4:8]]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])


def test_endless_reads_across_epoch_boundaries(cpus):
    """An epoch holds 4 reads, and the barrier wants 8 in flight at once:
    they meet only if the next epoch's reads start before this epoch's
    batches are taken, as the window runs on across the boundary."""
    cpus(64)
    dataset = _Rendezvous(4, 8)
    it = endless(DataLoader(dataset, batch_size=1))
    names = [next(it)["name"][0] for _ in range(16)]
    dataset.barrier.abort()      # free the reads still waiting
    it.close()
    assert names == [f"v{i}" for i in range(4)] * 4


def _take(it, n):
    """``n`` batches of an endless iterator, copied out of its buffers."""
    return [{k: np.array(v) if hasattr(v, "shape") else v
             for k, v in next(it).items()} for _ in range(n)]


def _assert_batches_equal(got, want):
    assert [b["name"] for b in got] == [list(b["name"]) for b in want]
    for a, b in zip(got, want):
        for key in ("image", "segmentation"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("workers", [2, None])
def test_endless_matches_the_jax_loader(cpus, workers):
    """The port's ``endless`` over its pool (2 threads, and the host's 16)
    yields the JAX package's batches over several shuffled epochs."""
    cpus(64)
    ours = DataLoader(_Volumes(9), batch_size=2, shuffle=True, seed=11,
                      num_workers=workers)
    theirs = JaxDataLoader(_Volumes(9), batch_size=2, shuffle=True, seed=11)
    assert ours.num_workers == (workers or 16)
    got_it, want_it = endless(ours), jax_endless(theirs)
    got, want = _take(got_it, 5 * len(theirs)), _take(want_it, 5 * len(theirs))
    got_it.close()
    want_it.close()
    assert len(theirs) == 4
    assert [b["name"] for b in want[:4]] != [b["name"] for b in want[4:8]]
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("workers", [2, None])
def test_partial_batch_kept_where_the_jax_pool_drops_it(cpus, workers):
    """Under ``drop_last=False`` the port yields each epoch's trailing
    partial batch at every pool size, as ``len`` counts it and as the JAX
    package's one-thread path yields it.  The JAX package's pool path
    drops it, against its own ``len``: an intended difference."""
    cpus(64)

    def jax_loader(num_workers):
        return JaxDataLoader(_Volumes(7), batch_size=2, shuffle=True, seed=4,
                             drop_last=False, num_workers=num_workers)

    ours = DataLoader(_Volumes(7), batch_size=2, shuffle=True, seed=4,
                      drop_last=False, num_workers=workers)
    assert len(ours) == len(jax_loader(1)) == 4
    assert len(list(jax_loader(2))) == 3
    got_it, want_it = endless(ours), jax_endless(jax_loader(1))
    got, want = _take(got_it, 12), _take(want_it, 12)
    got_it.close()
    want_it.close()
    assert [len(b["name"]) for b in got] == [2, 2, 2, 1] * 3
    _assert_batches_equal(got, want)


class _Slow(_Volumes):
    """Reads of at least ``SLOW_READ_S`` each."""

    def __getitem__(self, i):
        time.sleep(SLOW_READ_S)
        return super().__getitem__(i)


SLOW_READ_S = 0.01


def test_decode_seconds_grows_with_each_sample():
    loader = DataLoader(_Slow(6, sleep=0), batch_size=2, prefetch=0,
                        num_workers=1)
    seen = [loader.decode_seconds]
    for _ in loader:
        seen.append(loader.decode_seconds)
    assert seen[0] == 0.0
    steps = np.diff(seen)
    assert len(steps) == 3 and (steps >= 2 * SLOW_READ_S).all()
    pooled = DataLoader(_Slow(6, sleep=0), batch_size=2, num_workers=3)
    list(pooled)
    assert pooled.decode_seconds >= 6 * SLOW_READ_S


def test_decode_seconds_loses_no_read_under_contention(monkeypatch):
    """Many more threads than cores add to the counter at once: a clock
    that advances by exactly 1 between a thread's two readings makes every
    read count 1, so a lost update would show."""
    local = threading.local()

    def perf_counter():
        local.t = getattr(local, "t", 0) + 1
        return float(local.t)

    monkeypatch.setattr(loader_mod, "time", types.SimpleNamespace(
        perf_counter=perf_counter, monotonic=time.monotonic))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = DataLoader(_Volumes(2000, sleep=0), batch_size=4,
                            num_workers=32)
        assert len(list(loader)) == 500
    finally:
        sys.setswitchinterval(interval)
    assert loader.decode_seconds == 2000.0
