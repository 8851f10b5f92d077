"""Stage wall-clock timing (reference parity).

The reference's entire observability is ``timeit.default_timer`` deltas
written to its log (``DPathSim_APVPA.py:26,37,63,67``). StageTimer keeps
that capability. On CUDA, torch returns before the device finishes, so a
stage's edges synchronize the device: a stage's time then covers the
device work it enqueued, not just the enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


class StageTimer:
    """Accumulates named stage timings (``.stages``: (name, seconds))."""

    def __init__(self, device=None):
        self.stages: list[tuple[str, float]] = []
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages.append((name, time.perf_counter() - t0))

    def total(self) -> float:
        return sum(dt for _, dt in self.stages)

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out
