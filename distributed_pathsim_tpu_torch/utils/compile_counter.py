"""Compile accounting for the serving path: bucket warmup and a counter
of everything the port compiles at run time.

The port has no jit: its own run-time compiles are the kernel builds
of ``ops/cuda_kernels.py`` (one ``nvcc`` per kernel source, then the
``ctypes`` load of the built library) and its CUDA-graph captures: the
learned tier's train step is captured once per batch shape and replayed
after that (``models/neural._GraphedStep``, kind ``"cuda_graph"``). A
knob resolved inside a capture would be frozen into it; the analyzer's
RS001 (``analysis/recompile.py``) keeps knobs out of every capture.
Each such event goes through :func:`record`, which tells every
registered listener — the process-lifetime registry counter that
:func:`install_compile_metrics` installs, and any
:class:`CompileCounter` in scope. A warm service must
read 0 new compiles across queries and updates: every bucket's shapes
were driven once by :func:`warm_compile_cache` and every kernel library
is built and loaded once per process.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np

# The kinds :func:`record` takes: an nvcc build, the ctypes load of a
# built library, a CUDA-graph capture.
KINDS = ("nvcc", "load", "cuda_graph")

_LISTENERS: list[Callable[[str, str], None]] = []
_LISTENERS_LOCK = threading.Lock()


def record(kind: str, name: str) -> None:
    """One run-time compile of ``kind`` (see :data:`KINDS`) for the
    kernel ``name``: every listener hears of it."""
    if kind not in KINDS:
        raise ValueError(f"unknown compile kind {kind!r}; choose from {KINDS}")
    with _LISTENERS_LOCK:
        listeners = list(_LISTENERS)
    for fn in listeners:
        fn(kind, name)


def _add_listener(fn: Callable[[str, str], None]) -> None:
    with _LISTENERS_LOCK:
        _LISTENERS.append(fn)


def _remove_listener(fn: Callable[[str, str], None]) -> None:
    with _LISTENERS_LOCK:
        if fn in _LISTENERS:
            _LISTENERS.remove(fn)


def warm_compile_cache(
    backend,
    buckets,
    k: int = 10,
    variant: str = "rowsum",
) -> dict[int, float]:
    """Drive every serving shape bucket once at startup.

    One throwaway ``topk_rows`` call per bucket size runs the very
    gather + batched GEMM the coalescer will dispatch, so the first real
    request of every bucket finds its device buffers allocated and its
    GEMM configuration chosen instead of paying that mid-query.

    Emits one structured ``compile_warm`` event per bucket with the
    measured warm time; returns {bucket: seconds}. Works against any
    backend exposing ``topk_rows``."""
    from .logging import runtime_event

    times: dict[int, float] = {}
    for b in sorted(set(int(x) for x in buckets)):
        rows = np.zeros(b, dtype=np.int64)
        t0 = time.perf_counter()
        backend.topk_rows(rows, k=k, variant=variant)
        times[b] = time.perf_counter() - t0
        runtime_event(
            "compile_warm",
            echo=False,
            backend=getattr(backend, "name", "?"),
            bucket=b,
            k=k,
            seconds=round(times[b], 6),
        )
    return times


# Name of the registry counter the service's ``health`` op reports.
COMPILES_METRIC = "dpathsim_kernel_compiles_total"
_INSTALL_LOCK = threading.Lock()
_INSTALLED = False


def _count_in_registry(kind: str, name: str) -> None:
    from ..obs.metrics import get_registry

    get_registry().counter(
        COMPILES_METRIC, "kernel builds, loads and graph captures since "
        "process start",
    ).inc(kind=kind)


def install_compile_metrics() -> bool:
    """Register the PROCESS-LIFETIME listener that counts every compile
    into the obs registry (:data:`COMPILES_METRIC`, labeled by kind) —
    the always-on companion of the scoped :class:`CompileCounter`. A
    steady-state serving process whose count moves is compiling, which
    the serving contract forbids; the ``health`` and ``metrics`` ops
    make that visible live. Idempotent; returns True."""
    global _INSTALLED
    with _INSTALL_LOCK:
        if not _INSTALLED:
            _add_listener(_count_in_registry)
            _INSTALLED = True
    return True


def compiles_total() -> int:
    """Compiles the registry has counted since process start (0 before
    :func:`install_compile_metrics`)."""
    from ..obs.metrics import get_registry

    fam = get_registry().counter(COMPILES_METRIC)
    return int(sum(cell.get() for _, cell in fam.cells()))


class CompileCounter:
    """Counts run-time compiles while in scope — the zero-new-compiles
    assertion hook of the serving contract. Context manager; ``count``
    is cumulative while registered and ``by_kind`` splits it."""

    def __init__(self):
        self.count = 0
        self.by_kind: dict[str, int] = {}
        self._lock = threading.Lock()

    def _on_event(self, kind: str, name: str) -> None:
        with self._lock:
            self.count += 1
            self.by_kind[kind] = self.by_kind.get(kind, 0) + 1

    def __enter__(self) -> "CompileCounter":
        _add_listener(self._on_event)
        return self

    def __exit__(self, *exc) -> None:
        _remove_listener(self._on_event)
