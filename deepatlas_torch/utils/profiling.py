"""Profiling and spans (counterpart of ``deepatlas_tpu/utils/profiling.py``).

  * ``annotate`` -- a named span: its start and end on ``time.perf_counter``
    go to one process-wide, bounded span log, read by ``spans_between``;
    while ``torch.profiler`` records, a span on the main thread also opens
    a ``record_function`` marker, so that the trace carries it.
  * ``trace`` -- a ``torch.profiler`` trace (host and, on a card, device
    activity) written under a directory.
  * ``device_memory_stats`` -- the card's allocator counters under the JAX
    package's names; ``{}`` for the CPU.
  * ``sync`` -- wait for the work queued on a device.

Span names are ``<layer>.<what>``: ``data.decode`` (mostly on the loader's
threads), ``experiment.copy_in`` / ``.step`` / ``.log``, ``step.forward`` /
``.loss`` / ``.backward``, ``tiling.pad`` / ``.cut`` / ``.stitch`` /
``.copy_in`` / ``.predict`` / ``.copy_out``.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import torch


def sync(device: Union[str, torch.device]) -> None:
    """Block until the work queued on ``device`` is done (a CUDA device
    runs asynchronously; on the CPU there is nothing to wait for)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and the
    card where there is one) and write its trace under ``log_dir``
    (``<host>_<pid>.<time>.pt.trace.json``, readable by TensorBoard's
    profiler plugin and by Perfetto).  Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


# the span log: ``(name, start, end)`` of every closed span of every
# thread, in the order they closed; the oldest drop out first
SPAN_LOG_LENGTH = 2 ** 16
_LOG: deque = deque(maxlen=SPAN_LOG_LENGTH)
_MAIN = threading.main_thread()


class annotate:
    """A named span (a context manager, like ``torch.profiler``'s
    ``record_function``; one use each).  It logs its start and end on
    ``time.perf_counter`` (``spans_between``), and while the profiler
    records it opens a ``record_function`` marker too -- on the main thread
    only, which runs the steps and the serving calls: the trace's spans
    name the device's idle gaps whatever thread they ran on, so a span of a
    loader thread would take over the main thread's gaps.  It never waits
    on the device."""
    __slots__ = ("name", "start", "_marker")

    def __init__(self, name: str):
        self.name = name
        self._marker = None

    def __enter__(self) -> "annotate":
        if torch.autograd.profiler._is_profiler_enabled \
                and threading.current_thread() is _MAIN:
            self._marker = torch.profiler.record_function(self.name)
            self._marker.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        if self._marker is not None:
            self._marker.__exit__(*exc)
            self._marker = None
        _LOG.append((self.name, self.start, end))


def spans_between(t0: float, t1: float
                  ) -> Optional[List[Tuple[str, float, float]]]:
    """The logged spans that started at or after ``t0`` and ended at or
    before ``t1``, as ``(name, start, end)`` in the order they closed; None
    where the log may have dropped such a span (it is full, and its oldest
    span ended at or after ``t0``)."""
    events = _LOG.copy()
    if len(events) == events.maxlen and events[0][2] >= t0:
        return None
    return [e for e in events if e[1] >= t0 and e[2] <= t1]


def device_memory_stats(device: Union[str, torch.device] = "cuda"
                        ) -> Dict[str, int]:
    """Bytes in use, the peak since the last reset and the card's total,
    as ``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit``; empty
    for the CPU or where there is no card."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}
