"""Profiling: stage wall-clock (reference parity) + device traces.

The reference's entire observability is ``timeit.default_timer`` deltas
written to its log (``DPathSim_APVPA.py:26,37,63,67``). StageTimer keeps
that capability as a thin shim over the tracer: every ``stage()`` opens
a hierarchical span named ``stage:<name>`` (visible in ``--trace-out``
Perfetto dumps, nested under whatever span is current), records the
duration into the ``dpathsim_stage_seconds`` histogram, appends to
``.stages`` and, with a logger, emits the ``stage_time`` JSONL event.
On CUDA, torch returns before the device finishes, so when the timer is
given a CUDA ``device`` a stage's edges synchronize it: the stage's time
then covers the device work it enqueued, not just the enqueue.

:func:`device_trace` adds what the reference never had — a
``torch.profiler`` trace of the run (host ops and the card's kernels,
the hand-written ones included) as Chrome trace-event JSON, viewable in
Perfetto; while it is open, tracer spans also annotate it
(``device_annotations``), so the host hierarchy and the kernels land in
one view.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from ..obs.metrics import get_registry
from ..obs.trace import get_tracer


class StageTimer:
    """Accumulates named stage timings (``.stages``: (name, seconds));
    integrates with ``RunLogger.metric`` when given a ``logger``."""

    def __init__(self, logger=None, device=None):
        self.stages: list[tuple[str, float]] = []
        self._logger = logger
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            with get_tracer().span(f"stage:{name}"):
                yield
                self._sync()
        finally:
            dt = time.perf_counter() - t0
            self.stages.append((name, dt))
            get_registry().histogram(
                "dpathsim_stage_seconds", "pipeline stage durations"
            ).observe(dt, stage=name)
            if self._logger is not None:
                self._logger.metric(event="stage_time", stage=name, seconds=dt)

    def total(self) -> float:
        return sum(dt for _, dt in self.stages)

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, dt in self.stages:
            out[name] = out.get(name, 0.0) + dt
        return out


# File name of the trace :func:`device_trace` writes into its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str | None) -> Iterator[None]:
    """``torch.profiler`` trace scope writing ``<log_dir>/trace.json``
    (Chrome trace-event JSON) at exit; a no-op when ``log_dir`` is None.
    It records the card's activity when a card is present and the host's
    always. While open, obs tracer spans mirror into the trace as
    ``record_function`` ranges."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracer = get_tracer()
    was_annotating = tracer.device_annotations
    prof = profile(activities=activities)
    tracer.configure(device_annotations=True)
    prof.start()
    try:
        yield
    finally:
        # written even when the run fails: the trace of a failing run
        # is the one most worth reading
        prof.stop()
        tracer.configure(device_annotations=was_annotating)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
