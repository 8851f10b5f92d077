"""The worker side of the router/worker split.

A worker is one warm :class:`~..serving.PathSimService` speaking an
*asynchronous* variant of the serve JSONL protocol: the read loop never
blocks on query work. ``topk`` requests are submitted to the service's
coalescer and answered out of order when their future resolves (matched
by ``id``/``request_id``), so concurrent router traffic actually
coalesces into batched dispatches, and ``health`` probes stay
answerable while queries are in flight — which is exactly what lets the
router tell a *dead* worker (no pong) from a *stalled* one (pongs flow,
answers don't; hedging territory).

Robustness contracts implemented here:

- **Idempotent retries**: mutating ops (``update``, ``invalidate``)
  dedup by ``request_id`` — a re-delivered broadcast replays the cached
  ack instead of applying the delta twice (the router re-sends missed
  deltas during catch-up, and a hedged/failed-over send may arrive
  after the original succeeded).
- **Graceful drain** (SIGTERM or the in-band ``drain`` op): stop
  accepting queries (each gets a retriable ``draining`` error the
  router reroutes), complete every in-flight request, emit the final
  accounting event, exit 0. No accepted request is dropped.
- **Chaos seam** ``worker_dispatch`` (resilience/inject.py): fired
  before each query submit. ``error`` → a retriable per-request
  failure; ``delay`` → a stalled read loop (the stall the router's
  hedging exists for); ``crash`` → the process dies like a real kill.

A ``topk`` may carry ``"mode": "ann"``: the service answers it through
its candidate index, or exactly when it cannot (a replica with no index
answers exactly, counted as ``no_index``), and the response's
``ann_fallback`` names the reason whenever the ANN path did not answer —
what lets the router's flight recorder keep every ann-degraded request.
``"mode": "learned"`` answers through the towers the same way, with a
``learned_fallback`` annotation (a replica without towers answers
ann-then-exact, counted as ``no_towers``). A partition worker (serving/partition.py) answers the
partition-exchange ops and refuses whole queries. ``batch_blocks`` (a batch campaign's row block, router/batch.py) is
answered synchronously like the other non-query ops. A ``topk`` naming another closed ``metapath``
answers through the service's engine for it, as ``serve`` does (the JAX
package's worker reads no ``metapath`` field on its async ``topk`` path
and answers the served metapath). The router sends such a request only
to a replica that has every update (router/core.py, delta fencing).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import OrderedDict
from typing import IO, Callable

import numpy as np

from ..obs.trace import from_wire, get_tracer
from ..resilience import (
    Deadline,
    inject,
    policy_from_env,
    resilient_call,
)
from ..serving.coalescer import LoadShedError, ServiceClosed
from ..serving.protocol import handle_request
from ..serving.service import PathSimService
from ..utils.logging import runtime_event

# ops whose effect must apply exactly once across retries — everything
# else is a deterministic read, safe to repeat anywhere. The partition
# pair (part_update / set_colsum) is the routed delta's two phases; a
# failed response is never cached.
MUTATING_OPS = frozenset({
    "update", "invalidate", "part_update", "set_colsum",
})

_DEDUP_CAPACITY = 1024

_NULL_CTX = contextlib.nullcontext()


class WorkerRuntime:
    """Protocol state for one worker process: async query completion,
    request-id dedup, drain bookkeeping. ``reply`` callables passed to
    :meth:`handle` must be thread-safe (completion fires on the
    coalescer's completer thread)."""

    def __init__(self, service: PathSimService, worker_id: str = "w0"):
        self.service = service
        self.worker_id = worker_id
        self.draining = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight: set = set()
        # request_id → response for mutating ops (bounded: the router
        # only ever retries recent requests; an evicted entry re-applies,
        # which for update is rejected loudly by the delta machinery)
        self._done: OrderedDict[str, dict] = OrderedDict()
        self.dedup_hits = 0

    # -- bookkeeping -------------------------------------------------------

    def _track(self, token) -> None:
        with self._lock:
            self._inflight.add(token)

    def _untrack(self, token) -> None:
        with self._lock:
            self._inflight.discard(token)
            if not self._inflight:
                self._idle.notify_all()

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def begin_drain(self, reason: str = "drain op") -> None:
        if not self.draining:
            self.draining = True
            runtime_event("worker_draining", worker_id=self.worker_id,
                          reason=reason, echo=False)

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every in-flight request has been answered (the
        drain contract). False on timeout — the caller still exits, but
        loudly."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
        return True

    # -- request handling --------------------------------------------------

    def handle(self, req: dict, reply: Callable[[dict], None]) -> str:
        """Process one request; returns a loop directive: ``"ok"``,
        ``"shutdown"``, or ``"drain"``. Every return path has called
        ``reply`` exactly once (async ops: will call it)."""
        op = req.get("op", "topk")
        rid = req.get("id")
        request_id = req.get("request_id")
        if op == "shutdown":
            reply({"id": rid, "ok": True, "result": {"shutdown": True}})
            return "shutdown"
        if op == "drain":
            self.begin_drain()
            reply({"id": rid, "ok": True, "result": {"draining": True}})
            return "drain"
        if op == "topk":
            self._handle_topk(req, reply)
            return "ok"
        if op in MUTATING_OPS and request_id is not None:
            with self._lock:
                cached = self._done.get(request_id)
            if cached is not None:
                # idempotent retry: same request_id → same answer,
                # the delta applied exactly once
                self.dedup_hits += 1
                reply({**cached, "id": rid, "deduped": True})
                return "ok"
        resp = handle_request(self.service, req)
        if op in MUTATING_OPS and request_id is not None and resp.get("ok"):
            with self._lock:
                self._done[request_id] = resp
                while len(self._done) > _DEDUP_CAPACITY:
                    self._done.popitem(last=False)
        reply(resp)
        return "ok"

    def _handle_topk(self, req: dict, reply: Callable[[dict], None]) -> None:
        """The async hot path: resolve + submit on the read thread,
        answer from the future's completion.

        Trace stitching: a ``trace`` context on the wire parents this
        worker's spans under the router's dispatch span. The
        ``worker.request`` span covers the full async lifecycle —
        opened here on the read thread, finished when the future
        resolves on the completer thread — and the service's
        ``serve.request`` tree hangs under it (the remote context is
        activated around the submit). A ``sampled: false`` context
        creates nothing anywhere downstream."""
        rid = req.get("id")
        request_id = req.get("request_id")
        deadline = Deadline.from_ms(req.get("deadline_ms"))
        tracer = get_tracer()
        rctx = from_wire(req.get("trace"))
        wspan = (
            tracer.start_span(
                "worker.request", parent=rctx,
                worker=self.worker_id, op="topk",
            )
            if rctx is not None else None
        )

        def fail(error: str, **flags) -> None:
            tracer.finish(wspan, outcome="error", error=error)
            resp = {"id": rid, "ok": False, "error": error, **flags}
            if request_id is not None:
                resp["request_id"] = request_id
            reply(resp)

        if self.draining:
            fail("draining", draining=True)
            return
        if deadline is not None and deadline.expired:
            fail("deadline expired on arrival", deadline_exceeded=True)
            return
        metapath = req.get("metapath")
        try:
            # the id-mapping type is read BEFORE dispatch (an update
            # racing the request may drop the metapath's engine)
            node_type = self.service.source_type(metapath)
            row = self.service.resolve(
                source=req.get("source"), source_id=req.get("source_id"),
                row=req.get("row"), metapath=metapath,
            )
        except (KeyError, ValueError) as exc:
            fail(str(exc.args[0] if exc.args else exc))
            return
        k = int(req.get("k") or self.service.config.k_default)
        mode = req.get("mode")
        if mode not in (None, "exact", "ann", "learned"):
            fail(f"unknown topk mode {mode!r}")
            return
        t0 = time.perf_counter()
        # Transient dispatch faults retry LOCALLY first, under a policy
        # CLAMPED to the caller's remaining budget (deadline_ms →
        # Deadline → RetryPolicy.deadline_s): a local retry is cheaper
        # than a router round-trip, but it must never spend time the
        # caller no longer has — when the budget (or attempts) runs
        # out, the transient error surfaces and the router reroutes.
        # The worker_dispatch seam fires per attempt: error → local
        # retry then retriable reply, delay → this read loop stalls
        # (the router's hedging territory), crash → the process dies
        # mid-batch (failover re-dispatch territory).
        policy = policy_from_env(max_attempts=2)
        if deadline is not None:
            policy = deadline.clamp(policy)
        # the remote trace context (or this worker's request span)
        # becomes the submit's ambient parent: the coalescer pipeline's
        # spans land inside the fleet trace
        ctx = wspan.context if wspan is not None else rctx
        # fallback annotation for the router's tail sampler: a
        # side-effect-free peek (the answering path counts it), read
        # BEFORE the submit so the response can say "this ann request
        # will answer exactly, and why"
        try:
            ann_fallback = self.service.ann_fallback_reason(
                row, mode, metapath=metapath)
        except Exception:
            ann_fallback = None
        try:
            learned_fallback = self.service.learned_fallback_reason(
                row, mode, metapath=metapath)
        except Exception:
            learned_fallback = None
        try:
            # mode rides through: a replica WITHOUT an index answers an
            # "ann" request exactly (counted as a no_index fallback) —
            # which is what makes re-dispatching an ann query onto any
            # surviving replica always safe
            with tracer.activate(ctx) if ctx is not None else _NULL_CTX:
                future = resilient_call(
                    "worker_dispatch",
                    lambda: self.service.submit_topk(
                        row, k, mode=mode, metapath=metapath),
                    policy,
                )
        except LoadShedError:
            fail("shed", shed=True)
            return
        except ServiceClosed:
            fail("worker closed", transient=True)
            return
        except inject.InjectedFault as exc:
            fail(str(exc), transient=True)
            return
        except (KeyError, ValueError, OverflowError) as exc:
            # a request this replica refuses deterministically (an open
            # metapath, the engine limit, the exact-count guard): every
            # replica would refuse it the same way
            fail(str(exc.args[0] if exc.args else exc))
            return
        token = object()
        self._track(token)

        def on_done(fut) -> None:
            try:
                exc = fut.exception()
                if exc is not None:
                    fail(f"dispatch failed: {exc!r}", transient=True)
                    return
                vals, idxs = fut.result()
                hits = []
                for v, i in zip(vals, idxs):
                    if not np.isfinite(v):
                        continue
                    i_id, lab = self.service._ident(int(i), node_type)
                    hits.append(
                        {"id": i_id, "label": lab, "score": float(v)}
                    )
                result = {"row": int(row), "topk": hits}
                if ann_fallback is not None:
                    result["ann_fallback"] = ann_fallback
                if learned_fallback is not None:
                    result["learned_fallback"] = learned_fallback
                resp = {
                    "id": rid,
                    "ok": True,
                    "result": result,
                    "latency_ms": round(
                        (time.perf_counter() - t0) * 1e3, 3
                    ),
                }
                if request_id is not None:
                    resp["request_id"] = request_id
                tracer.finish(wspan, outcome="ok")
                reply(resp)
            finally:
                self._untrack(token)

        future.add_done_callback(on_done)


def worker_loop(
    runtime: WorkerRuntime, in_stream: IO[str], out_stream: IO[str]
) -> int:
    """The worker process's main loop: JSONL in, JSONL out (responses
    out of order; matched by id). First line out is the ``ready`` event
    the router waits for. Returns 0 on shutdown/drain/EOF.

    SIGTERM (latched by the resilience preemption handler, installed by
    the worker CLI) takes effect at the next protocol event, same
    semantics as serve_loop's drain; the router's own drain path uses
    the in-band ``drain`` op, which needs no signal delivery."""
    from ..resilience import preemption_handler

    wlock = threading.Lock()

    def emit(obj: dict) -> None:
        line = json.dumps(obj) + "\n"
        with wlock:
            out_stream.write(line)
            out_stream.flush()

    svc = runtime.service
    emit({
        "event": "ready",
        "worker_id": runtime.worker_id,
        "n": svc.n,
        "backend": svc.backend.name,
        "base_fp": svc.consistency_token[0],
        "delta_seq": svc.consistency_token[1],
        "metapath": svc.metapath.name,
    })

    def finish(reason: str) -> int:
        runtime.begin_drain(reason)
        drained = runtime.wait_idle()
        try:
            svc.coalescer.drain()
        except TimeoutError:
            drained = False  # report it, still exit cleanly
        runtime_event(
            "worker_drained", worker_id=runtime.worker_id, reason=reason,
            clean=drained, dedup_hits=runtime.dedup_hits, echo=False,
        )
        emit({"event": "drained", "worker_id": runtime.worker_id,
              "clean": drained})
        return 0

    for line in in_stream:
        if preemption_handler.requested():
            return finish(preemption_handler.reason or "signal")
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            emit({"id": None, "ok": False, "error": f"bad request: {exc}"})
            continue
        directive = runtime.handle(req, emit)
        if directive == "shutdown":
            runtime.wait_idle()
            return 0
        if directive == "drain":
            return finish("drain op")
        if preemption_handler.requested():
            return finish(preemption_handler.reason or "signal")
    return finish("eof")
