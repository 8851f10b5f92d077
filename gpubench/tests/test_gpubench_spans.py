"""The readers of the port's spans (``result_path_ms``, ``host_fold_s``,
``factor_prep_s``) on a tracer state made by hand, with CUDA events
faked, and the accepted readers on a recorded run record: they read what
they read before the span readers came."""

from __future__ import annotations

import pytest
import torch

from distributed_pathsim_tpu_torch.obs import trace
from gpubench.harness import Bench, peaks_for
from gpubench.tests._tiny import REPO

BENCH = Bench(REPO)
H100 = peaks_for(REPO, "NVIDIA H100 80GB HBM3")


class _Event:
    """A completed CUDA event whose timestamps are set by hand (ms)."""

    stamps: list = []

    def __init__(self, enable_timing=False):
        self.t = _Event.stamps.pop(0)

    def record(self, stream):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def tracer(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")
    t = trace.Tracer(enabled=True, device_annotations=True)
    monkeypatch.setattr(trace, "_TRACER", t)
    return t


def _span(t, name, device_ms=None):
    """One finished span; ``device_ms`` its card time (None: no card)."""
    if device_ms is not None:
        _Event.stamps += [100.0, 100.0 + device_ms]
    with t.span(name, device=None if device_ms is None else "cuda"):
        pass


def _setup_and_window(t, calls=2, window_factor=False):
    """Set-up's spans, the clear at the window's start, then ``calls``
    rank-alls' spans. Returns the set-up's fold seconds."""
    with t.span("backend.init"):
        _span(t, "backend.fold")
        _span(t, "backend.factor", 250.0)
    _span(t, "backend.factor", 500.0)
    _span(t, "backend.limbs", 125.0)
    fold_s = next(s.duration_s for s in t.spans() if s.name == "backend.fold")
    t.clear()
    for _ in range(calls):
        with t.span("driver.rank_all"):
            _span(t, "backend.result_alloc", 10.0)
            for tile in range(2):
                _span(t, "backend.tile", 300.0)  # kernels: not the result path
                _span(t, "backend.fetch", 0.5)
                _span(t, "backend.drain", 1.0 if tile else 0.0)
            _span(t, "driver.to_f64", 5.0)
        if window_factor:  # a rebuild inside the window: not set-up's
            _span(t, "backend.factor", 7.0)
    return fold_s


def _read(name, run):
    return BENCH.reader(name).read(run)


@pytest.mark.parametrize("calls,window_factor", [(2, False), (3, True)])
def test_span_readers_do_the_arithmetic(tracer, calls, window_factor):
    fold_s = _setup_and_window(tracer, calls, window_factor)
    run = {"calls": calls}
    # a call: 10 + 2 × 0.5 + 0 + 1 + 5 ms on the result path
    assert _read("result_path_ms", run) == pytest.approx(17.0)
    assert _read("factor_prep_s", run) == pytest.approx(0.875)
    assert _read("host_fold_s", run) == pytest.approx(fold_s)
    assert 0 < fold_s < tracer.totals()["backend.init"]["host_s"]


def test_span_readers_read_none_without_spans_or_device_time(
        tracer, monkeypatch):
    run = {"calls": 3}
    names = ("result_path_ms", "host_fold_s", "factor_prep_s")
    assert [_read(n, run) for n in names] == [None] * 3
    # spans with no device time: a set-up traced without the card
    with tracer.span("backend.init"):
        _span(tracer, "backend.fold")
    _span(tracer, "backend.factor")
    tracer.clear()
    _span(tracer, "backend.fetch")
    assert [_read(n, run) for n in names] == [None] * 3
    # a program without the span names (the parent of these readers)
    monkeypatch.setattr(trace, "_TRACER", trace.Tracer(
        enabled=True, device_annotations=True))
    _setup_and_window(trace.get_tracer())
    monkeypatch.delattr(trace, "RESULT_PATH_SPANS")
    assert [_read(n, run) for n in names] == [None] * 3


def test_accepted_readers_read_a_record_as_before(tracer):
    _setup_and_window(tracer)  # the span readers' state changes nothing
    run = {"n": 1 << 20, "v": 64, "k": 10, "calls": 12, "window_s": 51.5,
           "pairs_per_call": float(1 << 20) * ((1 << 20) - 1),
           "setup_s": 14.25, "backend_init_s": 3.5, "peaks": H100,
           "trace": {"window_s": 51.25, "busy_s": 50.5, "kernel_s": 49.0,
                     "device_ops": [], "idle_gaps": []}}
    n = 1 << 20
    least = max(float(n) * n * 64 / H100["int8_ops_per_s"],
                (4.0 * n * 64 + 4.0 * n + 8.0 * n * 10)
                / H100["hbm_bytes_per_s"])
    want = {
        "rank_all_pairs_per_s": run["pairs_per_call"] * 12 / 51.5,
        "setup_s": 14.25,
        "backend_init_s": 3.5,
        "topk_roofline": 100.0 * least / (49.0 / 12),
        "device_idle_pct": 100.0 * (1.0 - 50.5 / 51.25),
    }
    assert {m: _read(m, run) for m in want} == want
