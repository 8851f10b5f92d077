"""Hierarchical tracing spans with cross-thread context propagation.

"Where did this request's p99 go" needs one connected timeline per
request — but a served query crosses three threads (the submitting
client, the coalescer's dispatcher, its completer), so a thread-local
"current span" alone cannot connect it. This tracer provides both
halves:

- **In-thread**: ``tracer.span(name)`` is a context manager that
  parents to the calling thread's current span (a ``contextvars``
  slot) and restores it on exit — nested ``with`` blocks become a
  span tree with zero caller bookkeeping.
- **Cross-thread**: ``tracer.start_span(...)`` / ``tracer.finish(...)``
  split the lifecycle so a span can open on one thread and close on
  another (the coalescer's enqueue span opens at ``submit`` and closes
  when the dispatcher picks the request up); ``tracer.activate(ctx)``
  re-roots the current-span slot on a worker thread so downstream
  ``span()`` calls parent into the migrated trace.

Every span carries ``(trace_id, span_id, parent_id)``; a root span's
``span_id`` is its ``trace_id``, and children inherit the trace id
through whichever propagation path delivered the parent. That triple is
what the connectivity test walks and what Perfetto's JSON args expose.

Clock discipline: span timestamps are ``time.monotonic_ns()`` — the
SAME monotonic clock ``utils.logging.timestamps()`` stamps into every
JSONL event as ``ts_mono``, so events and spans join on one axis. The
wall anchor (one ``time.time()`` reading at tracer init, the sanctioned
exception to the no-wall-clock-durations rule) maps monotonic
timestamps onto the epoch microseconds Chrome/Perfetto expect.

Finished spans land in a bounded ring (``max_spans``, oldest dropped) —
tracing a long-lived server must never grow without bound. Disabled
(the default), ``span()`` costs one attribute check; the serving hot
path stays unmeasurable.

Cross-PROCESS propagation (for a fleet of serving processes): span ids are
globally unique — each tracer draws a random 48-bit id base at init, so
a router process and its worker subprocesses can never mint colliding
ids — and a span's identity travels on the JSONL protocol as a tiny
``trace`` dict (:func:`to_wire` / :func:`from_wire`). The receiving
process activates the wire context and every span it opens parents into
the ORIGINATING process's trace; merging the per-process rings
yields one stitched Perfetto timeline. The wire context also carries the HEAD sampling decision:
``{"sampled": false}`` tells the receiver to create zero spans for this
request (the dropped-head sentinel travels with the request), so the
configured 1/N rate holds fleet-wide instead of per process.

Head-based sampling (``sample_every``): span bookkeeping is
GIL-serialized Python, so tracing EVERY request costs tens of
microseconds of serialized work per request — fine for debugging, too
much to leave on under CPU-bound load. The production posture (the
same one Dapper-style tracers ship) is to decide at the trace HEAD:
every Nth root span starts a trace, and an unsampled request creates
ZERO span objects anywhere downstream (children only exist under a
live parent). ``sample_every=1`` (the default) traces everything;
sampled-in traces are complete and connected either way.
``device_annotations=True`` additionally opens a
``torch.profiler.record_function`` range per span, so spans show up
inside a ``torch.profiler`` trace of the card, attaching the host-side
hierarchy to the CUDA kernel timeline. A span opened with a CUDA
``device`` also records a timing event on that device's current stream
at its opening and at its closing, so it carries the card's seconds
between the two (:attr:`Span.device_s`): torch returns before the card
finishes, so host seconds alone mismeasure a span that enqueues card
work. Nothing synchronizes: ``device_s`` stays None until both events
have completed, and is read when asked for.

Beside the ring, the tracer keeps per-name totals of every span
finished (:meth:`Tracer.totals`: count, host seconds, device seconds),
which neither the ring's bound nor :meth:`Tracer.clear` drops: a
breakdown of set-up outlives the clear that starts a measured window.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Iterator

_MONO_NS = time.monotonic_ns

# Span names that the benchmark's readers sum, one tuple each, so that a
# rename is made here and in the span's own line only. The host fold of
# the symmetric half (set-up); the factor made ready for the kernels on
# the card (the scatter-build, the densify, the K3-ready copy, the row
# sums, the u8 limb split); and rank-all's result path (the host result
# buffers, the fetch, each row tile's drain, the driver's f64 cast).
FOLD_SPANS = ("backend.fold",)
FACTOR_SPANS = ("backend.factor", "backend.limbs")
RESULT_PATH_SPANS = ("backend.result_alloc", "backend.fetch",
                     "backend.drain", "driver.to_f64")
# Pass 2 of the exact K1 (ops/cuda_kernels.fused_topk_twopass_exact): its
# args carry ``f64_scores``, the elements K1 scored in f64 (defer_arg).
PASS2_SPAN = "backend.pass2"


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a live span: everything a child on
    another thread needs to parent correctly."""

    trace_id: int
    span_id: int


# The sampled-OUT marker: when a trace head is dropped by head
# sampling, its scope's current-span slot holds this sentinel instead
# of None, so parentless spans underneath it are recognized as
# descendants of a dropped head (suppressed outright) rather than as
# fresh heads — otherwise every nested "root" would tick the sampler
# again and the configured 1/N rate would not hold. Real ids start at
# a positive id base, so (0, 0) can never collide with a live span.
_DROPPED = SpanContext(0, 0)


def to_wire(ctx: "SpanContext | None", sampled: bool = True) -> dict:
    """A span context as the protocol's ``trace`` field. ``ctx=None``
    with ``sampled=False`` propagates a dropped-head decision (the
    receiver must create no spans); ``ctx=None`` with ``sampled=True``
    is an empty dict — "no opinion", the receiver traces on its own."""
    if ctx is None or ctx is _DROPPED:
        return {"sampled": False} if not sampled or ctx is _DROPPED else {}
    return {"trace_id": int(ctx.trace_id), "span_id": int(ctx.span_id)}


def from_wire(trace: dict | None) -> SpanContext | None:
    """Parse a protocol ``trace`` field back into the context to
    ``activate()``. Returns None (no propagation — local behavior
    unchanged), the dropped-head sentinel (``sampled: false`` — spans
    suppressed downstream), or a live remote parent context."""
    if not trace:
        return None
    if trace.get("sampled") is False:
        return _DROPPED
    tid, sid = trace.get("trace_id"), trace.get("span_id")
    if tid is None or sid is None:
        return None
    return SpanContext(int(tid), int(sid))


class Span:
    """One timed operation. Mutable only through the tracer (``finish``
    seals it); ``args`` entries must be JSON-safe."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "t_start_ns", "t_end_ns", "tid", "thread_name", "args",
        "_events", "_device_s", "_deferred",
    )

    def __init__(
        self,
        name: str,
        trace_id: int,
        span_id: int,
        parent_id: int | None,
        args: dict[str, Any],
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start_ns = _MONO_NS()
        self.t_end_ns: int | None = None
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.args = args
        # (start, end) CUDA events of a span opened with a device under
        # device_annotations; end is None while the span is open
        self._events = None
        self._device_s: float | None = None
        # args still being computed on the card: name → pinned host copy
        # (Tracer.defer_arg), set once the closing event has completed
        self._deferred: dict | None = None

    @property
    def device_s(self) -> float | None:
        """The card's seconds from the span's opening to its closing on
        the stream it was opened on: the work it enqueued there, and the
        time that stream waited for the host in between. None for a span
        without events, and until its closing event has completed (an
        event is queried, never waited for)."""
        if self._device_s is None and self._events is not None:
            start, end = self._events
            if end is not None and end.query():
                self._device_s = start.elapsed_time(end) / 1e3
                self._events = None
                for name, host in (self._deferred or {}).items():
                    self.args[name] = host.item()
                self._deferred = None
        return self._device_s

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        end = self.t_end_ns if self.t_end_ns is not None else _MONO_NS()
        return (end - self.t_start_ns) / 1e9

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start_ns": self.t_start_ns,
            "t_end_ns": self.t_end_ns,
            "tid": self.tid,
            "thread": self.thread_name,
            "args": dict(self.args),
        }
        if self.device_s is not None:
            out["device_s"] = self.device_s
        return out


class Tracer:
    """Span factory + finished-span ring + current-span propagation."""

    def __init__(
        self,
        enabled: bool = False,
        max_spans: int = 200_000,
        device_annotations: bool = False,
        sample_every: int = 1,
    ):
        self.enabled = enabled
        self.device_annotations = device_annotations
        self.sample_every = int(sample_every)
        self._lock = threading.Lock()
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=max_spans
        )
        # name → [count, host seconds, device seconds or None]; the spans
        # whose device time is still running wait in _unsettled (oldest
        # first, as their events complete) and join the totals later
        self._totals: dict[str, list] = {}
        self._unsettled: collections.deque[Span] = collections.deque(
            maxlen=max_spans
        )
        # Globally-unique ids: a random 48-bit base per tracer, local
        # counter on top. Two processes of one fleet can never mint the
        # same span id, so cross-process stitching (trace contexts on
        # the wire, rings merged at export) needs no id translation.
        # The base is strictly positive, so the (0, 0) dropped-head
        # sentinel stays uncollidable.
        self._id_base = (
            (int.from_bytes(os.urandom(6), "big") | 1) << 24
        )
        self._ids = itertools.count(1)
        # root admissions seen, for deterministic head sampling
        # (itertools.count is C-level and GIL-atomic: no lock needed)
        self._root_seen = itertools.count()
        self._current: contextvars.ContextVar[SpanContext | None] = (
            contextvars.ContextVar("pathsim_current_span", default=None)
        )
        # wall anchor: the one sanctioned wall-clock reading — maps
        # monotonic ns onto epoch µs for Chrome trace-event ts fields
        self._wall_anchor_us = time.time() * 1e6 - _MONO_NS() / 1e3

    def configure(
        self,
        enabled: bool | None = None,
        max_spans: int | None = None,
        device_annotations: bool | None = None,
        sample_every: int | None = None,
    ) -> None:
        with self._lock:
            if enabled is not None:
                self.enabled = enabled
            if device_annotations is not None:
                self.device_annotations = device_annotations
            if sample_every is not None:
                if sample_every < 1:
                    raise ValueError(
                        f"sample_every must be >= 1, got {sample_every}"
                    )
                self.sample_every = int(sample_every)
            if max_spans is not None and max_spans != self._spans.maxlen:
                self._spans = collections.deque(
                    self._spans, maxlen=max_spans
                )
                self._unsettled = collections.deque(
                    self._unsettled, maxlen=max_spans
                )

    # -- lifecycle -----------------------------------------------------------

    def current(self) -> SpanContext | None:
        return self._current.get()

    def start_span(
        self,
        name: str,
        parent: SpanContext | None = None,
        **args: Any,
    ) -> Span | None:
        """Open a span (cross-thread form: caller owns ``finish``).
        ``parent=None`` parents to the calling thread's current span;
        pass an explicit context to parent across a thread hop. Returns
        None when tracing is disabled — ``finish(None)`` is a no-op, so
        callers need no enabled-checks of their own.

        A parentless span is a trace HEAD: with ``sample_every=n`` only
        every nth head starts a trace (the rest return None, and their
        would-be children never exist). Spans with a live parent are
        never dropped — a sampled-in trace is always complete — and
        spans under a DROPPED head are always suppressed without
        ticking the sampler (one head decision per trace, whichever
        call happens to sit outermost)."""
        if not self.enabled:
            return None
        if parent is None:
            parent = self._current.get()
        if parent is _DROPPED:
            return None
        if parent is None and self.sample_every > 1:
            if next(self._root_seen) % self.sample_every:
                return None
        span_id = self._id_base + next(self._ids)
        if parent is None:
            trace_id, parent_id = span_id, None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        return Span(name, trace_id, span_id, parent_id, args)

    def finish(self, span: Span | None, **args: Any) -> None:
        """Seal a span and land it in the ring. First finish wins: a
        second call is a no-op, so overlapping error paths (a batch
        failing after some members already resolved) can finish
        defensively without duplicating ring entries or rewriting an
        already-recorded outcome."""
        if span is None or span.t_end_ns is not None:
            return
        span.args.update(args)
        span.t_end_ns = _MONO_NS()
        with self._lock:
            self._spans.append(span)
            total = self._totals.get(span.name)
            if total is None:
                total = self._totals[span.name] = [0, 0.0, None]
            total[0] += 1
            total[1] += (span.t_end_ns - span.t_start_ns) / 1e9
            if span._events is not None:
                self._unsettled.append(span)
            self._settle(everything=False)

    def _settle(self, everything: bool) -> None:
        """Move the device seconds of unsettled spans whose events have
        completed into the totals: the oldest ones (at each finish, so
        the queue holds only what is in flight), or every one. Caller
        holds the lock."""
        queue = self._unsettled
        if everything:
            self._unsettled = collections.deque(maxlen=queue.maxlen)
            for span in queue:
                if span.device_s is None:
                    self._unsettled.append(span)
                else:
                    self._add_device_s(span)
            return
        while queue and queue[0].device_s is not None:
            self._add_device_s(queue.popleft())

    def _add_device_s(self, span: Span) -> None:
        total = self._totals[span.name]
        total[2] = (total[2] or 0.0) + span.device_s

    @contextlib.contextmanager
    def span(self, name: str, parent: SpanContext | None = None,
             device: Any = None, **args: Any) -> Iterator[Span | None]:
        """In-thread form: opens, becomes the current span, restores on
        exit. Exceptions mark the span (``error=repr``) and propagate.
        ``device``: where the span enqueues work; with
        ``device_annotations`` on and a CUDA device, the span times its
        stretch of that device's current stream (:attr:`Span.device_s`)."""
        if not self.enabled:
            yield None
            return
        s = self.start_span(name, parent=parent, **args)
        if s is None:
            # sampled out (or enabled flipped off mid-call): poison the
            # scope with the dropped sentinel so parentless spans
            # underneath neither trace nor tick the sampler again
            token = self._current.set(_DROPPED)
            try:
                yield None
            finally:
                self._current.reset(token)
            return
        token = self._current.set(s.context)
        annotation = stream = None
        if self.device_annotations:
            try:
                import torch

                annotation = torch.profiler.record_function(name)
                annotation.__enter__()
            except Exception:
                annotation = None
            stream = (None if device is None
                      else _open_device_events(s, device))
        try:
            yield s
        except BaseException as exc:
            _close_device_events(s, stream)
            self.finish(s, error=repr(exc))
            raise
        else:
            _close_device_events(s, stream)
            self.finish(s)
        finally:
            if annotation is not None:
                try:
                    annotation.__exit__(None, None, None)
                except Exception:
                    pass
            self._current.reset(token)

    def defer_arg(self, span: Span | None, name: str, value) -> None:
        """Set ``span.args[name]`` to the value of ``value``, a
        one-element tensor that the card may still be computing, without
        waiting for it: a copy to pinned host memory is queued on the
        span's stream, and the arg is set where ``device_s`` is read, once
        the span's closing event (queued after the copy) has completed.
        Only a span timed on the card (opened with a CUDA ``device``
        under ``device_annotations``) carries it; a CPU tensor is read at
        once."""
        if span is None:
            return
        if value.device.type != "cuda":
            span.args[name] = value.item()
            return
        if span._events is None or span._events[1] is not None:
            return
        import torch

        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        host.copy_(value, non_blocking=True)
        if span._deferred is None:
            span._deferred = {}
        span._deferred[name] = host

    @contextlib.contextmanager
    def child_span(self, name: str, **args: Any) -> Iterator[Span | None]:
        """Like :meth:`span`, but only when a current span exists —
        the form for mid-pipeline segments (host transfer, cache fill)
        that must vanish when their request's trace head was sampled
        out, instead of starting orphan root traces."""
        cur = self._current.get()
        if not self.enabled or cur is None or cur is _DROPPED:
            yield None
            return
        with self.span(name, **args) as s:
            yield s

    @contextlib.contextmanager
    def activate(self, ctx: SpanContext | None) -> Iterator[None]:
        """Re-root the calling thread's current span to ``ctx`` — the
        receiving half of a cross-thread handoff: spans opened inside
        parent into the migrated trace."""
        token = self._current.set(ctx)
        try:
            yield
        finally:
            self._current.reset(token)

    # -- inspection / export -------------------------------------------------

    def spans(self) -> list[Span]:
        """Finished spans, oldest first (ring-bounded)."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        """Empty the ring (:meth:`totals` keep counting)."""
        with self._lock:
            self._spans.clear()

    def totals(self) -> dict[str, dict]:
        """Per span name, over every span finished since the tracer was
        made: ``count``, ``host_s`` and ``device_s``, the device seconds
        of those of its spans whose events have completed (None where
        none has device time)."""
        with self._lock:
            self._settle(everything=True)
            return {name: {"count": c, "host_s": h, "device_s": d}
                    for name, (c, h, d) in self._totals.items()}

    def chrome_trace(self) -> dict:
        """Finished spans as Chrome trace-event JSON (the format
        Perfetto and chrome://tracing load): one complete ("X") event
        per span, per-thread tracks, span identity in ``args``."""
        pid = os.getpid()
        events: list[dict] = []
        seen_tids: dict[int, str] = {}
        for s in self.spans():
            end_ns = s.t_end_ns if s.t_end_ns is not None else s.t_start_ns
            events.append(
                {
                    "name": s.name,
                    "cat": "pathsim",
                    "ph": "X",
                    "pid": pid,
                    "tid": s.tid,
                    "ts": self._wall_anchor_us + s.t_start_ns / 1e3,
                    "dur": (end_ns - s.t_start_ns) / 1e3,
                    "args": {
                        "trace_id": s.trace_id,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                        **s.args,
                        **({} if s.device_s is None
                           else {"device_s": s.device_s}),
                    },
                }
            )
            seen_tids.setdefault(s.tid, s.thread_name)
        for tid, tname in seen_tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_state(self, limit: int | None = None) -> dict:
        """The ring as JSON-safe state for cross-process merging: span
        dicts, this process's pid, and the wall anchor that maps its
        monotonic timestamps onto epoch µs (all fleet processes share
        one host clock, so anchored timestamps align across exports).
        ``limit`` keeps only the newest N spans — the ``trace`` protocol
        op's payload must stay bounded on the wire."""
        spans = self.spans()
        if limit is not None and len(spans) > limit:
            spans = spans[-limit:]
        return {
            "pid": os.getpid(),
            "wall_anchor_us": self._wall_anchor_us,
            "spans": [s.to_dict() for s in spans],
        }

    def write_chrome_trace(self, path: str) -> int:
        """Dump the ring as Perfetto-loadable JSON (atomic rename —
        a trace viewer must never read a half-written file). Returns
        the number of span events written."""
        doc = self.chrome_trace()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


def _open_device_events(span: Span, device: Any):
    """Record ``span``'s opening event on ``device``'s current stream and
    return that stream, or None where ``device`` is no card."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    span._events = (start, None)
    return stream


def _close_device_events(span: Span, stream) -> None:
    """Record ``span``'s closing event on the stream it opened on."""
    if stream is None:
        return
    import torch

    end = torch.cuda.Event(enable_timing=True)
    end.record(stream)
    span._events = (span._events[0], end)


_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _TRACER
