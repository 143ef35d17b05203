"""Profiling and throughput observability (counterpart of
``deepatlas_tpu/utils/profiling.py``).

  * ``trace`` / ``annotate`` -- a ``torch.profiler`` trace (host and, on a
    card, device activity) written under a directory, and named spans in
    it (``torch.profiler.record_function``).
  * ``device_memory_stats`` -- the card's allocator counters under the JAX
    package's names; ``{}`` for the CPU.
  * ``ThroughputMeter`` -- steps/sec and volumes/sec/chip, EMA-smoothed.
  * ``sync`` -- wait for the work queued on a device.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

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


def annotate(name: str):
    """Named span in the profiler's timeline (a context manager)."""
    return torch.profiler.record_function(name)


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


class ThroughputMeter:
    """steps/sec and volumes/sec/chip counters with EMA smoothing."""

    def __init__(self, n_chips: int = 1, ema: float = 0.9):
        self.n_chips = max(n_chips, 1)
        self.ema = ema
        self._last: Optional[float] = None
        self._rate: Optional[float] = None
        self.steps = 0
        self.volumes = 0

    def start(self) -> None:
        self._last = time.perf_counter()

    def step(self, volumes: int = 1) -> None:
        """Record one completed step that processed ``volumes`` volumes."""
        now = time.perf_counter()
        self.steps += 1
        self.volumes += volumes
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                rate = volumes / dt
                self._rate = (rate if self._rate is None
                              else self.ema * self._rate
                              + (1 - self.ema) * rate)
        self._last = now

    @property
    def volumes_per_sec(self) -> float:
        return self._rate or 0.0

    @property
    def volumes_per_sec_per_chip(self) -> float:
        return (self._rate or 0.0) / self.n_chips

    def summary(self) -> Dict[str, float]:
        return {"steps": self.steps, "volumes": self.volumes,
                "volumes_per_sec": round(self.volumes_per_sec, 4),
                "volumes_per_sec_per_chip":
                    round(self.volumes_per_sec_per_chip, 4)}
