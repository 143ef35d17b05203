"""Batching iterator with a background prefetch thread.

A prefetch thread plus an optional decode pool: ``num_workers`` threads run
the per-sample NIfTI inflate/parse/preprocess concurrently, a bounded
in-flight window keeps memory flat, and ordered collection keeps batches
deterministic.  The pool is sized from the CPUs the process may use
(``host_num_workers``; its share where several ranks share the host),
except over a dataset whose reads draw from a random state its
``running_transform`` shares between the threads: those draws depend on
the thread count, so such a dataset keeps ``auto_num_workers(batch_size)``.  The iterator accounts the time the
consumer spends blocked on ingest (``wait_seconds`` / ``wait_fraction``)
and the pool the time its reads take (``decode_seconds``); each sample's
read is a ``data.decode`` span (logged; no profiler marker on the loader's
threads).

Each iterator owns its collation buffer ring and its producer thread: two
iterations of one loader never share buffers, and an iterator that is
dropped before the end stops its producer instead of leaving it blocked.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..utils.profiling import annotate


MAX_WORKERS = 16


def auto_num_workers(batch_size: int) -> int:
    """Decode-pool size scaled to the batch, bounded by twice the host's
    cores and a cap of 16: the size over datasets whose draws depend on the
    thread count."""
    cores = os.cpu_count() or 1
    return max(2, min(batch_size, 2 * cores, MAX_WORKERS))


def _read_quota(cgroup: str, v2: bool) -> Optional[float]:
    """One cgroup's CPU quota in CPUs (v2 ``cpu.max``, v1
    ``cpu.cfs_quota_us`` over ``cpu.cfs_period_us``); None where it sets
    none or none can be read."""
    try:
        if v2:
            with open(os.path.join(cgroup, "cpu.max")) as f:
                quota, period = f.read().split()[:2]
        else:
            with open(os.path.join(cgroup, "cpu.cfs_quota_us")) as f:
                quota = f.read().strip()
            with open(os.path.join(cgroup, "cpu.cfs_period_us")) as f:
                period = f.read().strip()
        if quota == "max" or int(quota) <= 0:
            return None
        return int(quota) / int(period)
    except (OSError, ValueError):
        return None


def _cgroup_cpu_quota(root: str = "/sys/fs/cgroup",
                      proc: str = "/proc/self/cgroup") -> Optional[float]:
    """The CPUs' worth of time this process's cgroups allow: the smallest
    quota from its own cgroup, as ``proc`` names it, up to the root of the
    hierarchy mounted at ``root`` (v1's ``cpu`` controller where it has
    one, else v2); None where no quota is set or none can be read.  A
    cgroup the mount does not show (inside a container) is passed over."""
    paths = {}
    try:
        with open(proc) as f:
            for line in f:
                _, controllers, path = line.rstrip("\n").split(":", 2)
                for controller in controllers.split(","):
                    paths[controller] = path
    except (OSError, ValueError):
        pass
    v2 = "cpu" not in paths
    base = root if v2 else os.path.join(root, "cpu")
    path = paths.get("" if v2 else "cpu", "/")
    quotas = []
    while True:
        quota = _read_quota(os.path.join(base, path.lstrip("/")), v2)
        if quota is not None:
            quotas.append(quota)
        if path in ("/", ""):
            return min(quotas, default=None)
        path = os.path.dirname(path)


def usable_cpus() -> int:
    """The CPUs this process may run on (its affinity mask), cut to its
    cgroups' CPU quota where one is set."""
    try:
        cpus = len(os.sched_getaffinity(0))
    except AttributeError:          # no affinity call on this platform
        cpus = os.cpu_count() or 1
    quota = _cgroup_cpu_quota()
    if quota is not None:
        cpus = min(cpus, max(1, int(quota)))
    return cpus


def host_num_workers() -> int:
    """Decode-pool size from the host: this process's share of the usable
    CPUs (torchrun's ``LOCAL_WORLD_SIZE`` ranks on one host each run a
    loader) less one for the thread that queues the steps and one for the
    loader's producer, between 2 and 16."""
    ranks = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
    return max(2, min(usable_cpus() // ranks - 2, MAX_WORKERS))


class _BufferRing:
    """Recycled collation buffers: ``depth`` preallocated arrays per
    (key, shape, dtype), handed out round-robin.  Writing into warm pages
    is much cheaper than into fresh ones on large volumes; a yielded batch
    stays valid until ``depth`` further batches have been produced."""

    def __init__(self, depth: int):
        self.depth = max(2, int(depth))
        self._slots: dict = {}

    def get(self, key, shape, dtype) -> np.ndarray:
        slot_key = (key, shape, np.dtype(dtype))
        slot = self._slots.get(slot_key)
        if slot is None:
            bufs = [np.empty(shape, dtype) for _ in range(self.depth)]
            self._slots[slot_key] = slot = [bufs, 0]
        bufs, i = slot
        slot[1] = (i + 1) % self.depth
        return bufs[i]


def _stack_samples(samples: Sequence, ring: Optional[_BufferRing] = None,
                   prefix: str = ""):
    """Stack sample dicts into a batch dict of arrays; non-array values
    (names) become lists.  Tuple samples (the (moving, fixed) pairs of the
    registration datasets) become a tuple of such batches.  With a ``ring``
    the arrays are written into recycled buffers instead of fresh
    allocations (``prefix`` keeps a tuple's members in separate slots)."""
    if isinstance(samples[0], tuple):
        return tuple(_stack_samples([s[i] for s in samples], ring, f"{i}/")
                     for i in range(len(samples[0])))
    out: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            if ring is not None:
                buf = ring.get(prefix + key, (len(vals),) + vals[0].shape,
                               vals[0].dtype)
                for i, v in enumerate(vals):
                    buf[i] = v
                out[key] = buf
            else:
                out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Epoch-oriented batch iterator over an indexable dataset.

    Args:
      dataset: supports ``__len__`` and ``__getitem__`` -> sample dict.
      batch_size: samples per batch (volumes must share shapes).
      shuffle: reshuffle indices each epoch.
      drop_last: drop the trailing partial batch.
      prefetch: batches staged ahead by the background thread (0 disables
        threading).
      num_workers: decode-pool threads (0 or 1: read on the producer
        thread); default ``host_num_workers()``, or
        ``auto_num_workers(batch_size)`` over a dataset with a
        ``running_transform``.
      collate: ``list of samples -> batch``; default stacks into the
        iterator's buffer ring.

    Batch lifetime: with the default collate a yielded batch's arrays are
    overwritten after ``prefetch + 3`` further batches of the same
    iterator; a consumer that keeps host batches longer copies them.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 num_workers: Optional[int] = None,
                 collate: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        if num_workers is None:
            # a running transform's random crops draw from one random state
            # that the pool's threads share, so its draws (and the balanced
            # sampler's unlocked class cycle) depend on the thread count
            num_workers = (auto_num_workers(batch_size)
                           if getattr(dataset, "running_transform", None)
                           else host_num_workers())
        self.num_workers = num_workers
        self.collate = collate
        self._rng = np.random.RandomState(seed)
        self.wait_seconds = 0.0
        self.total_seconds = 0.0
        # summed duration of the reads, from every thread of the pool
        self.decode_seconds = 0.0
        self._decode_lock = threading.Lock()

    @property
    def wait_fraction(self) -> float:
        """Fraction of iteration wall-clock spent blocked on ingest."""
        return self.wait_seconds / self.total_seconds \
            if self.total_seconds > 0 else 0.0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def _decode(self, i: int):
        t0 = time.perf_counter()
        with annotate("data.decode"):
            sample = self.dataset[i]
        seconds = time.perf_counter() - t0
        with self._decode_lock:
            self.decode_seconds += seconds
        return sample

    def _samples(self, epochs: Optional[int]):
        """``(index, ends_a_batch)`` of ``epochs`` epochs one after another
        (None: without end), each epoch shuffled as it is reached."""
        if len(self) == 0:
            return
        for _ in itertools.count() if epochs is None else range(epochs):
            for batch_idx in self._batch_indices():
                for k, i in enumerate(batch_idx):
                    yield int(i), k == len(batch_idx) - 1

    def _produce(self, collate: Callable, epochs: Optional[int]):
        samples = self._samples(epochs)
        if self.num_workers <= 1:
            batch: list = []
            for i, last in samples:
                batch.append(self._decode(i))
                if last:
                    yield collate(batch)
                    batch = []
            return
        # decode pool: per-sample futures over a bounded window, collected
        # in order (deterministic batches regardless of workers); the
        # window runs on across epochs, so an epoch's first reads overlap
        # the last batches of the one before
        window = self.num_workers + self.batch_size * max(self.prefetch, 1)
        with ThreadPoolExecutor(self.num_workers) as pool:
            futs: deque = deque()

            def submit() -> None:
                nxt = next(samples, None)
                if nxt is not None:
                    futs.append((pool.submit(self._decode, nxt[0]), nxt[1]))

            for _ in range(window):
                submit()
            batch = []
            while futs:
                fut, last = futs.popleft()
                batch.append(fut.result())
                submit()
                if last:
                    yield collate(batch)
                    batch = []

    def __iter__(self) -> Iterator[dict]:
        return self._iterate(epochs=1)

    def _iterate(self, epochs: Optional[int]) -> Iterator[dict]:
        if self.collate is None:
            ring = _BufferRing(self.prefetch + 3)
            collate = lambda samples: _stack_samples(samples, ring)  # noqa: E731
        else:
            collate = self.collate
        if self.prefetch <= 0:
            yield from self._produce(collate, epochs)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()
        errors = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self._produce(collate, epochs):
                    if not put(batch):
                        return
            except Exception as e:  # surfaced to the consumer below
                errors.append(e)
            put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        last = time.monotonic()
        try:
            while True:
                t0 = time.monotonic()
                item = q.get()
                now = time.monotonic()
                self.wait_seconds += now - t0
                self.total_seconds += now - last
                last = now
                if item is sentinel:
                    if errors:
                        raise errors[0]
                    return
                yield item
        finally:
            stop.set()
            t.join(timeout=60)


def endless(loader: DataLoader) -> Iterator[dict]:
    """Cycle a loader forever (one training epoch draws a fixed number of
    batches, whatever the dataset's length): its epochs one after another,
    the same batches as iterating it again and again, through one producer
    and decode pool whose window runs across epoch boundaries."""
    return loader._iterate(epochs=None)
