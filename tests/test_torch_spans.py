"""The spans inside the port's rank-all and set-up (``obs/trace.py``'s
``FOLD_SPANS``, ``FACTOR_SPANS``, ``RESULT_PATH_SPANS`` and
``backend.tile``), on the CPU with the kernels' plain versions: where
they open, what they nest in, the bytes they report, that a disabled
tracer makes none of them and changes no output, that ``torch.profiler``
sees them on its clock, and the device time a span takes from CUDA
events without a synchronize."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.driver import PathSimDriver
from distributed_pathsim_tpu_torch.obs import trace
from distributed_pathsim_tpu_torch.obs.trace import Tracer, get_tracer
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

K = 5
BACKENDS = {
    "dense": ("torch", {}),
    "sparse": ("torch-sparse", {"tile_rows": 64, "rect_kernel": True}),
}


@pytest.fixture(scope="module")
def hin():
    return synthetic_hin(300, 500, 6, seed=1)


@pytest.fixture
def tracer(monkeypatch):
    """A fresh process tracer for one case (the port reads it through
    ``get_tracer()`` at each span)."""
    t = Tracer()
    monkeypatch.setattr(trace, "_TRACER", t)
    assert get_tracer() is t
    return t


def _run(hin, arm, tracer, enabled=True, annotations=False):
    """Set-up (``create_backend`` + ``global_walks``) and one rank-all
    under the tracer; returns (set-up spans, rank-all spans, backend,
    output)."""
    tracer.configure(enabled=enabled, device_annotations=annotations)
    name, opts = BACKENDS[arm]
    backend = create_backend(name, hin,
                             compile_metapath("APVPA", hin.schema),
                             device="cpu", **opts)
    backend.global_walks()
    setup = tracer.spans()
    tracer.clear()
    out = PathSimDriver(backend).rank_all(K)
    return setup, tracer.spans(), backend, out


def _one(spans, name):
    (span,) = [s for s in spans if s.name == name]
    return span


def _inside(inner, outer, spans):
    """``inner`` descends from ``outer`` (parent links) and lies in its
    interval."""
    by_id = {s.span_id: s for s in spans}
    node = inner
    while node.parent_id is not None and node.parent_id != outer.span_id:
        node = by_id[node.parent_id]
    return (node.parent_id == outer.span_id
            and outer.t_start_ns <= inner.t_start_ns
            and inner.t_end_ns <= outer.t_end_ns)


def case_setup_spans(hin, arm, tracer, monkeypatch):
    setup, _, _, _ = _run(hin, arm, tracer)
    init = _one(setup, "backend.init")
    fold = _one(setup, "backend.fold")
    assert _inside(fold, init, setup) and fold.args["nnz"] > 0
    assert [s for s in setup if s.name == "backend.factor"]
    # the card's spans carry device time only on the card
    assert all(s.device_s is None for s in setup)


def case_rank_all_spans(hin, arm, tracer, monkeypatch):
    _, spans, backend, _ = _run(hin, arm, tracer)
    root = _one(spans, "driver.rank_all")
    cast = _one(spans, "driver.to_f64")
    assert _inside(cast, root, spans)
    if arm == "dense":
        assert _inside(_one(spans, "backend.fetch"), root, spans)
        return
    assert _inside(_one(spans, "backend.result_alloc"), root, spans)
    tiles = [s for s in spans if s.name == "backend.tile"]
    drains = [s for s in spans if s.name == "backend.drain"]
    live = backend._n_live_tiles
    assert [s.args["tile"] for s in tiles] == list(range(live))
    assert [s.args["tile"] for s in drains] == list(range(live))
    tile_rows = backend.tiled.tile_rows
    assert [s.args["rows"] for s in tiles] == [
        min(tile_rows, backend.n - i * tile_rows) for i in range(live)]
    assert {s.args["arm"] for s in tiles} == {"rect"}
    assert all(_inside(s, root, spans) for s in tiles + drains)


def case_bytes(hin, arm, tracer, monkeypatch):
    setup, spans, backend, (vals, idxs) = _run(hin, arm, tracer)
    n = backend.n_sources
    cast = _one(spans, "driver.to_f64")
    factors = [s.args["bytes"] for s in setup + spans
               if s.name == "backend.factor"]
    if arm == "dense":
        c, rowsums = backend._half()
        assert factors == [sum(t.nbytes for t in backend._coo),
                           c.nbytes + rowsums.nbytes]
        fetch = _one(spans, "backend.fetch")
        assert fetch.args == {"pinned": False,
                              "bytes": n * K * (4 + idxs.itemsize)}
        assert cast.args["bytes"] == vals.nbytes  # f32 → f64; int64 kept
        return
    t = backend.tiled
    # the row sums' upload and tiles, the densified C, K3's ready copy
    # (f32 already: none)
    assert factors[1:] == [t.n_tiles * t.tile_rows * t.v * 4, 0]
    assert factors[0] > 0
    assert _one(spans, "backend.result_alloc").args["bytes"] == (
        vals.nbytes + idxs.nbytes)
    drains = [s for s in spans if s.name == "backend.drain"]
    # the f32 values cast to f64; the plain K3's indices are int64 already
    assert [s.args["bytes"] for s in drains] == [
        min(t.tile_rows, n - i * t.tile_rows) * K * 8
        for i in range(len(drains))]
    assert cast.args["bytes"] == 0  # already f64 and int64


def case_disabled(hin, arm, tracer, monkeypatch):
    made = {"spans": 0, "events": 0, "annotations": 0}
    start_span = Tracer.start_span

    def counting_start(self, *a, **kw):
        made["spans"] += 1
        return start_span(self, *a, **kw)

    record_function = torch.profiler.record_function

    def counting_annotation(*a, **kw):
        made["annotations"] += 1
        return record_function(*a, **kw)

    def counting_event(*a, **kw):
        made["events"] += 1
        raise AssertionError("no CUDA event on the CPU")

    monkeypatch.setattr(Tracer, "start_span", counting_start)
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting_annotation)
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    _, _, _, off = _run(hin, arm, tracer, enabled=False, annotations=True)
    assert made == {"spans": 0, "events": 0, "annotations": 0}
    assert tracer.spans() == [] and tracer.totals() == {}
    _, _, _, on = _run(hin, arm, tracer, enabled=True, annotations=True)
    assert made["spans"] > 0 and made["annotations"] == made["spans"]
    assert made["events"] == 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def case_no_sync_added(hin, arm, tracer, monkeypatch):
    """Tracing adds no synchronize, ``.cpu()`` or ``.item()``: each is
    called as often with the tracer on as with it off."""
    calls = {"cpu": 0, "item": 0, "synchronize": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(torch.Tensor, "cpu", counted("cpu", torch.Tensor.cpu))
    monkeypatch.setattr(torch.Tensor, "item",
                        counted("item", torch.Tensor.item))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted("synchronize", torch.cuda.synchronize))
    _run(hin, arm, tracer, enabled=False)
    off = dict(calls)
    calls.update(cpu=0, item=0, synchronize=0)
    _run(hin, arm, tracer, enabled=True, annotations=True)
    assert calls == off


def case_profiler_clock(hin, arm, tracer, monkeypatch):
    """With ``device_annotations`` the spans are mirrored into
    ``torch.profiler`` as host events, on the profiler's own clock,
    nested inside ``driver.rank_all``."""
    from torch.profiler import ProfilerActivity, profile

    tracer.configure(enabled=True, device_annotations=True)
    name, opts = BACKENDS[arm]
    backend = create_backend(name, hin,
                             compile_metapath("APVPA", hin.schema),
                             device="cpu", **opts)
    backend.global_walks()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        PathSimDriver(backend).rank_all(K)
    events = prof.events()
    (root,) = [e for e in events if e.name == "driver.rank_all"]
    want = ({"backend.fetch", "driver.to_f64"} if arm == "dense" else
            {"backend.result_alloc", "backend.tile", "backend.drain",
             "driver.to_f64"})
    inner = [e for e in events if e.name in want]
    assert {e.name for e in inner} == want
    assert all(root.time_range.start <= e.time_range.start
               and e.time_range.end <= root.time_range.end for e in inner)


class _FakeEvent:
    """A CUDA event's timing surface: ``record`` stamps the next
    millisecond, ``query`` says whether the card has reached it."""

    clock = 0.0
    made: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        _FakeEvent.made.append(self)

    def record(self, stream):
        assert stream == "stream"
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t - self.t


def case_device_events(hin, arm, tracer, monkeypatch):
    """A span opened with a CUDA device under ``device_annotations``
    records an event at each end on the device's current stream, and
    reads its ``device_s`` only once the closing event has completed;
    no synchronize anywhere. Without annotations it makes no event."""
    def no_sync(*a, **kw):
        raise AssertionError("the tracer must not synchronize")

    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    cuda = torch.device("cuda")
    t = Tracer(enabled=True, device_annotations=False)
    with t.span("backend.tile", device=cuda):
        pass
    assert _FakeEvent.made == [] and t.spans()[0].device_s is None
    t.configure(device_annotations=True)
    with t.span("backend.tile", device=cuda) as span:
        with t.span("backend.fetch", device=cuda):
            pass
    start, fetch_start, fetch_end, end = _FakeEvent.made
    assert span.device_s is None and t.totals()["backend.tile"][
        "device_s"] is None
    end.done = True
    assert span.device_s == pytest.approx((end.t - start.t) / 1e3)
    totals = t.totals()
    assert totals["backend.tile"] == {"count": 2, "host_s": pytest.approx(
        sum(s.duration_s for s in t.spans() if s.name == "backend.tile")),
        "device_s": pytest.approx(0.003)}
    assert totals["backend.fetch"]["device_s"] is None  # still running
    fetch_end.done = True
    assert t.totals()["backend.fetch"]["device_s"] == pytest.approx(0.001)
    assert t.spans()[-1].to_dict()["device_s"] == pytest.approx(0.003)
    # the totals outlive the ring's clear
    t.clear()
    assert t.spans() == [] and t.totals()["backend.tile"]["count"] == 2
    assert trace.RESULT_PATH_SPANS[1] == "backend.fetch"


@pytest.mark.cuda
@pytest.mark.parametrize("arm", list(BACKENDS))
def test_spans_time_the_card(arm, hin, tracer):
    """On the card every span opened with the card carries ``device_s``
    once its events have completed, the row tiles' stretches of the
    stream fit inside the rank-all, and the output is the untraced
    one's. Run on the card with ``python -m pytest --noconftest -m cuda
    tests/test_torch_spans.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

    ck.true_f32()
    name, opts = BACKENDS[arm]
    outs = []
    for enabled in (False, True):
        tracer.configure(enabled=enabled, device_annotations=enabled)
        backend = create_backend(name, hin,
                                 compile_metapath("APVPA", hin.schema),
                                 device="cuda", **opts)
        backend.global_walks()
        tracer.clear()
        outs.append(PathSimDriver(backend).rank_all(K))
    torch.cuda.synchronize()  # the test's own wait: every event completed
    spans = tracer.spans()
    timed = [s for s in spans if s.name != "driver.rank_all"]
    assert timed and all(s.device_s is not None and s.device_s >= 0
                         for s in timed)
    totals = tracer.totals()
    assert totals["backend.limbs"]["device_s"] > 0
    assert totals["backend.factor"]["device_s"] > 0
    (root,) = [s for s in spans if s.name == "driver.rank_all"]
    tiles = sum(s.device_s for s in spans if s.name == "backend.tile")
    assert tiles <= root.duration_s * 1.01 + 1e-3
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


CASES = {
    "setup_spans": case_setup_spans,
    "rank_all_spans": case_rank_all_spans,
    "bytes": case_bytes,
    "disabled": case_disabled,
    "no_sync_added": case_no_sync_added,
    "profiler_clock": case_profiler_clock,
}


@pytest.mark.parametrize("case,arm", [
    *[(c, arm) for c in CASES for arm in BACKENDS], ("device_events", None)])
def test_rank_all_and_setup_spans(case, arm, hin, tracer, monkeypatch):
    fn = case_device_events if case == "device_events" else CASES[case]
    fn(hin, arm, tracer, monkeypatch)
