"""Batching iterator with a background prefetch thread.

A prefetch thread plus an optional decode pool: ``num_workers`` threads run
the per-sample NIfTI inflate/parse/preprocess concurrently, a bounded
in-flight window keeps memory flat, and ordered collection keeps batches
deterministic.  The iterator accounts the time the consumer spends blocked
on ingest (``wait_seconds`` / ``wait_fraction``).

Each iterator owns its collation buffer ring and its producer thread: two
iterations of one loader never share buffers, and an iterator that is
dropped before the end stops its producer instead of leaving it blocked.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np


def auto_num_workers(batch_size: int) -> int:
    """Decode-pool size scaled to the batch, bounded by twice the host's
    cores and a cap of 16."""
    cores = os.cpu_count() or 1
    return max(2, min(batch_size, 2 * cores, 16))


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
        self.num_workers = (auto_num_workers(batch_size)
                            if num_workers is None else num_workers)
        self.collate = collate
        self._rng = np.random.RandomState(seed)
        self.wait_seconds = 0.0
        self.total_seconds = 0.0

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

    def _produce(self, collate: Callable):
        if self.num_workers <= 1:
            for batch_idx in self._batch_indices():
                yield collate([self.dataset[int(i)] for i in batch_idx])
            return
        # decode pool: per-sample futures over a bounded window, collected
        # in order (deterministic batches regardless of workers)
        window = self.num_workers + self.batch_size * max(self.prefetch, 1)
        flat = [int(i) for bi in self._batch_indices() for i in bi]
        with ThreadPoolExecutor(self.num_workers) as pool:
            futs: deque = deque(pool.submit(self.dataset.__getitem__, i)
                                for i in flat[:window])
            pos = len(futs)
            batch: list = []
            while futs:
                batch.append(futs.popleft().result())
                if pos < len(flat):
                    futs.append(pool.submit(self.dataset.__getitem__,
                                            flat[pos]))
                    pos += 1
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []

    def __iter__(self) -> Iterator[dict]:
        if self.collate is None:
            ring = _BufferRing(self.prefetch + 3)
            collate = lambda samples: _stack_samples(samples, ring)  # noqa: E731
        else:
            collate = self.collate
        if self.prefetch <= 0:
            yield from self._produce(collate)
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
                for batch in self._produce(collate):
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
    batches, whatever the dataset's length)."""
    while True:
        yield from loader
