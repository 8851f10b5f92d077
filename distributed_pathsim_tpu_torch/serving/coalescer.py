"""Request coalescing: concurrent queries → padded batch dispatches.

The serving hot loop is dispatch-overhead-bound, not FLOP-bound: a
single-row query pays a kernel launch, a host-device round trip and the
host's f64 normalize for a GEMV that is microseconds of arithmetic. The
coalescer collapses that overhead: requests land in a bounded queue; a dispatcher thread
forms a batch (up to ``max_batch``, waiting at most ``max_wait_ms`` for
stragglers once the first request arrives), pads it to a power-of-two
shape bucket (buckets.py), and issues ONE batched dispatch.

**Double buffering**: the dispatcher hands the in-flight result (a
handle on a GEMM queued on the card's serving stream) to a completion
thread through a depth-2 queue and immediately forms the next batch —
so batch N+1's GEMM is issued while batch N's results transfer to host
and fan back out to their futures. With a synchronous backend (numpy) the same
structure degenerates gracefully: issue computes, complete routes.

**Admission control**: the queue is bounded (``queue_depth``). When
it's full the submit fails immediately with :class:`LoadShedError` and
a structured ``serve_shed`` event — shedding at the door keeps the
latency of admitted requests bounded instead of letting the queue grow
without limit under overload (the JSONL event stream is how an operator
sees it happening).

Every result is routed to exactly the future whose request produced it
(request identity, not value: two concurrent queries for the same row
each get their own completion) — verified under concurrent submitters
by test.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Sequence

import numpy as np

from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..utils.logging import runtime_event
from . import buckets as bk

# process-wide coalescer sequence: the `instance` label that keeps one
# service's queue-depth gauge / shed counter from merging with another's
_INSTANCE_IDS = itertools.count()


class LoadShedError(RuntimeError):
    """Admission refused: the serving queue is at its bound."""


class ServiceClosed(RuntimeError):
    """The service shut down before (or while) handling the request."""


@dataclasses.dataclass
class Request:
    """One admitted query. ``k`` is the requested top-k; the batch is
    dispatched at the batch's max k and each request gets its prefix.

    ``span`` is the request's ROOT tracing span (opened by whoever
    admitted the query, finished by whoever resolves the future — the
    completion thread on the happy path); ``enq_span`` covers the time
    the request sat in the queue, opened at submit and closed when the
    dispatcher picks it up. Both are None when tracing is off.
    ``t_submit`` is the admission timestamp from the SUBMITTER (taken
    before the cache lookups under the swap lock) — the origin the
    submit-to-resolve latency histogram measures from, shared with the
    cache-hit outcomes so the per-outcome distributions are
    origin-comparable; 0.0 when the caller didn't stamp one.

    ``lane`` routes the batch to one of the service's dispatch paths:
    a batch is single-lane (the batch former never mixes lanes):
    ``exact``, ``ann``, ``learned`` and one ``mp:<metapath>`` lane per
    secondary metapath each coalesce into batches of their own."""

    row: int
    k: int
    future: Future
    t_enqueue: float
    span: Any = None
    enq_span: Any = None
    t_submit: float = 0.0
    lane: str = "exact"


@dataclasses.dataclass
class BatchStats:
    """Per-dispatch accounting, folded into the service's stats."""

    n_requests: int
    bucket: int
    wait_ms: float


class Coalescer:
    """Batch former + double-buffered dispatch pipeline.

    ``issue(rows_padded, k, lane)`` runs on the dispatcher thread and
    returns an opaque in-flight handle (device array, host array —
    anything); ``complete(handle, rows, requests, k, lane)`` runs on
    the completion thread and must resolve every request's future.
    ``lane`` is the batch's (single) lane — the service dispatches on
    it. Exceptions from either land on every future of the batch.
    """

    def __init__(
        self,
        issue: Callable[[np.ndarray, int], Any],
        complete: Callable[[Any, np.ndarray, Sequence[Request], int], None],
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        queue_depth: int = 256,
        bucket_ladder: tuple[int, ...] | None = None,
        on_batch: Callable[[BatchStats], None] | None = None,
    ):
        self._issue = issue
        self._complete = complete
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.buckets = bucket_ladder or bk.bucket_ladder(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError(
                f"bucket ladder {self.buckets} cannot cover "
                f"max_batch={self.max_batch}"
            )
        self._on_batch = on_batch
        # obs handles, bound once: per-submit cost is one gauge set;
        # per-batch cost is two histogram observes + a labels() lookup.
        # queue depth and sheds are labeled per coalescer instance —
        # two services in one process must not last-write-wins each
        # other's gauge (a second service's empty queue would mask the
        # first one's backlog) or pool their shed attribution.
        instance = str(next(_INSTANCE_IDS))
        reg = get_registry()
        self._m_queue_depth = reg.gauge(
            "dpathsim_serve_queue_depth", "admitted requests waiting"
        ).labels(instance=instance)
        self._m_shed = reg.counter(
            "dpathsim_serve_shed_total", "requests refused at the bound"
        ).labels(instance=instance)
        # fixed pow-2 ladder, NOT this coalescer's bucket tuple: the
        # family is process-wide and its geometry belongs to the first
        # registrant — two services with different max_batch must not
        # fight over it (the registry raises on conflicting bounds)
        self._m_occupancy = reg.histogram(
            "dpathsim_serve_batch_occupancy",
            "requests per dispatched batch, by shape bucket",
            bounds=tuple(float(1 << i) for i in range(11)),
        )
        # labeled per LANE, cells bound lazily on first dispatch of a
        # lane: lanes of different dispatch cost have different
        # wait-time economics, and an SLO over batch wait must be able
        # to tell them apart
        self._m_wait_family = reg.histogram(
            "dpathsim_serve_batch_wait_seconds",
            "first-enqueue to dispatch wait per batch, by lane",
        )
        self._m_wait_cells: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queue: collections.deque[Request] = collections.deque()
        self._closing = False
        self.shed_count = 0
        self.batch_count = 0
        self.dispatched_requests = 0
        # Depth 2 = the double buffer: one batch completing + one in
        # flight; a third batch blocks at put() until a slot frees,
        # which back-pressures the dispatcher instead of racing ahead.
        self._inflight: queue.Queue = queue.Queue(maxsize=2)
        # Batches issued but not yet fully completed — the drain()
        # condition (a queue can look empty while the completion thread
        # is mid-batch, and reload must not swap state under it).
        self._inflight_n = 0
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="pathsim-serve-dispatch",
            daemon=True,
        )
        self._completer = threading.Thread(
            target=self._complete_loop, name="pathsim-serve-complete",
            daemon=True,
        )
        self._dispatcher.start()
        self._completer.start()

    # -- load signals ------------------------------------------------------

    @property
    def depth(self) -> int:
        """Admitted-but-undispatched requests right now (the health
        op's queue-depth signal; routers shed/route on it)."""
        with self._lock:
            return len(self._queue)

    @property
    def inflight(self) -> int:
        """Batches issued but not yet fully completed."""
        with self._lock:
            return self._inflight_n

    # -- admission ---------------------------------------------------------

    def submit(self, row: int, k: int, span=None,
               t_submit: float = 0.0, lane: str = "exact") -> Future:
        """Admit one query; returns its Future. Raises
        :class:`LoadShedError` immediately when the queue is at bound —
        overload must fail fast, not queue unboundedly.

        ``span``: the request's root tracing span, carried through the
        pipeline so the completion thread can finish it; an ``enqueue``
        child span opens here and closes when the dispatcher takes the
        request — queue time is where an overloaded server's p99 hides,
        so it must be its own segment in the trace."""
        fut: Future = Future()
        tracer = get_tracer()
        # only under a live root: an unsampled request (head sampling,
        # obs/trace.py) must create zero spans anywhere downstream —
        # a parentless enqueue here would start an orphan trace
        enq = (
            tracer.start_span(
                "serve.enqueue", parent=span.context, row=int(row)
            )
            if span is not None
            else None
        )
        with self._lock:
            if self._closing:
                # seal the just-opened enqueue segment before bailing:
                # an unfinished span never lands in the ring, and the
                # trace would silently lose its queue segment
                tracer.finish(enq, outcome="closed")
                raise ServiceClosed("serving layer is shut down")
            if len(self._queue) >= self.queue_depth:
                self.shed_count += 1
                shed = self.shed_count
                self._m_shed.inc()
                tracer.finish(enq, outcome="shed")
                # stderr echo only every 100th shed: under sustained
                # overload the event stream must not become the load
                runtime_event(
                    "serve_shed",
                    depth=self.queue_depth,
                    total_shed=shed,
                    echo=(shed == 1 or shed % 100 == 0),
                )
                raise LoadShedError(
                    f"serving queue at bound ({self.queue_depth}); "
                    "request shed"
                )
            self._queue.append(
                Request(row=int(row), k=int(k), future=fut,
                        t_enqueue=time.monotonic(), span=span,
                        enq_span=enq, t_submit=t_submit, lane=lane)
            )
            self._m_queue_depth.set(len(self._queue))
            self._not_empty.notify()
        return fut

    # -- pipeline ----------------------------------------------------------

    def _take_batch(self) -> list[Request] | None:
        """Block for the first request, then coalesce stragglers up to
        ``max_batch`` or ``max_wait``. Returns None on shutdown.

        Batches are single-lane: the head request's lane defines the
        batch, and coalescing stops at the first queued request of a
        different lane (FIFO order is preserved — the other lane heads
        the next batch), so batches of two lanes can never be padded
        into one dispatch."""
        with self._lock:
            while not self._queue:
                if self._closing:
                    return None
                self._not_empty.wait()
            # Counted as in flight from the moment the FIRST request
            # leaves the queue — before the straggler wait below, which
            # releases the lock: drain() must not report idle while a
            # batch is half-formed, or reload() could swap the backend
            # under it and dispatch old-graph rows against the new one.
            batch = [self._queue.popleft()]
            self._inflight_n += 1
            lane = batch[0].lane
            deadline = batch[0].t_enqueue + self.max_wait_s
            while len(batch) < self.max_batch:
                if self._queue:
                    if self._queue[0].lane != lane:
                        break
                    batch.append(self._queue.popleft())
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closing:
                    break
                self._not_empty.wait(remaining)
        return batch

    def _dispatch_loop(self) -> None:
        tracer = get_tracer()
        while True:
            batch = self._take_batch()
            if batch is None:
                self._inflight.put(None)  # completion-thread shutdown
                return
            with self._lock:
                self._m_queue_depth.set(len(self._queue))
            rows = np.array([r.row for r in batch], dtype=np.int64)
            k = max(r.k for r in batch)
            bucket = bk.bucket_for(rows.shape[0], self.buckets)
            padded = bk.pad_rows(rows, bucket)
            wait_ms = (
                time.monotonic() - batch[0].t_enqueue
            ) * 1e3
            # The thread hop: the batch's dispatch span parents to the
            # first TRACED request's root (a span has exactly one
            # parent), so that head trace contains the device work
            # directly. Every member's enqueue span (opened on its
            # submitter thread) closes here carrying
            # batch_span=<trace>:<span> naming the shared dispatch span
            # — the link non-head traces reach the device work through,
            # and what the bench audit resolves. A batch with no traced
            # member (head sampling) creates no spans at all.
            head = next((r for r in batch if r.span is not None), None)
            dispatch = (
                tracer.start_span(
                    "serve.dispatch", parent=head.span.context,
                    n=len(batch), bucket=bucket, k=k,
                    lane=batch[0].lane,
                )
                if head is not None
                else None
            )
            link = (
                f"{dispatch.trace_id}:{dispatch.span_id}"
                if dispatch is not None else None
            )
            for r in batch:
                if link is not None:
                    tracer.finish(r.enq_span, batch_span=link)
                else:
                    tracer.finish(r.enq_span)
            self._m_occupancy.observe(len(batch), bucket=bucket)
            lane = batch[0].lane
            wait_cell = self._m_wait_cells.get(lane)
            if wait_cell is None:
                wait_cell = self._m_wait_cells[lane] = (
                    self._m_wait_family.labels(lane=lane)
                )
            wait_cell.observe(wait_ms / 1e3)
            try:
                dev = (
                    tracer.start_span(
                        "serve.device_execute",
                        parent=dispatch.context, bucket=bucket,
                    )
                    if dispatch is not None
                    else None
                )
                try:
                    handle = self._issue(padded, k, batch[0].lane)
                finally:
                    tracer.finish(dev)
            except BaseException as exc:  # route, don't kill the thread
                tracer.finish(dispatch, error=repr(exc))
                for r in batch:
                    r.future.set_exception(exc)
                    tracer.finish(r.span, outcome="error")
                with self._lock:
                    self._inflight_n -= 1
                continue
            tracer.finish(dispatch)
            self.batch_count += 1
            self.dispatched_requests += len(batch)
            if self._on_batch is not None:
                self._on_batch(
                    BatchStats(
                        n_requests=len(batch), bucket=bucket,
                        wait_ms=wait_ms,
                    )
                )
            self._inflight.put(
                (handle, rows, batch, k,
                 dispatch.context if dispatch else None)
            )

    def _complete_loop(self) -> None:
        tracer = get_tracer()
        while True:
            item = self._inflight.get()
            if item is None:
                return
            handle, rows, batch, k, dispatch_ctx = item
            try:
                # activate() re-roots this worker thread into the
                # batch's trace: spans the completion callback opens
                # (host transfer, cache fill) parent under it.
                # child_span, not span: a batch whose traced head was
                # sampled out (ctx None) must not start orphan traces.
                with tracer.activate(dispatch_ctx):
                    with tracer.child_span("serve.complete", n=len(batch)):
                        self._complete(handle, rows, batch, k,
                                       batch[0].lane)
            except BaseException as exc:
                for r in batch:
                    # same guard for span and future: members the
                    # completion callback already resolved (and whose
                    # root span it already finished) must not be
                    # re-marked as errors
                    if not r.future.done():
                        r.future.set_exception(exc)
                        tracer.finish(r.span, outcome="error")
            finally:
                with self._lock:
                    self._inflight_n -= 1

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> None:
        """Wait until the queue and the in-flight pipeline are empty
        (reload uses this: no batch may straddle a backend swap)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._queue and self._inflight_n == 0
            if idle:
                return
            time.sleep(0.002)
        raise TimeoutError("serving pipeline did not drain")

    def close(self) -> None:
        with self._lock:
            self._closing = True
            pending = list(self._queue)
            self._queue.clear()
            self._not_empty.notify_all()
        tracer = get_tracer()
        for r in pending:
            r.future.set_exception(ServiceClosed("serving layer shut down"))
            tracer.finish(r.enq_span, outcome="closed")
            tracer.finish(r.span, outcome="closed")
        self._dispatcher.join(timeout=10)
        self._completer.join(timeout=10)
