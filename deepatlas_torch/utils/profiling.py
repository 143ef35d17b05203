"""Throughput observability (counterpart of
``deepatlas_tpu/utils/profiling.py``'s ``ThroughputMeter`` and ``sync``)."""
from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch


def sync(device: Union[str, torch.device]) -> None:
    """Block until the work queued on ``device`` is done (a CUDA device
    runs asynchronously; on the CPU there is nothing to wait for)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
