"""The ``serve`` wire protocol: JSONL over stdin/stdout.

One JSON object per line in, one per line out; the test suite drives it
through a pipe with no network dependency. A network front (HTTP, gRPC)
would be a thin adapter over :func:`handle_request`; the protocol layer
is deliberately transport-free. It is the JAX package's protocol, op for
op and field for field, for the ops the port serves.

Requests::

    {"id": 1, "op": "topk", "source": "Didier Dubois", "k": 10}
    {"id": 2, "op": "topk", "row": 17}
    {"id": 3, "op": "scores", "source_id": "author_395340"}
    {"id": 4, "op": "stats"}
    {"id": 5, "op": "invalidate"}
    {"id": 6, "op": "ping"}
    {"id": 7, "op": "shutdown"}
    {"id": 9, "op": "metrics"}
    {"id": 10, "op": "health"}
    {"id": 11, "op": "drain"}
    {"id": 12, "op": "topk", "row": 17, "request_id": "r42",
     "deadline_ms": 250.0}
    {"id": 13, "op": "trace", "limit": 1000}
    {"id": 14, "op": "topk", "row": 17, "metapath": "APTPA"}
    {"id": 15, "op": "scores", "row": 17, "metapath": "APA"}
    {"id": 16, "op": "compact"}
    {"id": 17, "op": "topk", "row": 17, "mode": "ann"}
    {"id": 18, "op": "refresh_index"}
    {"id": 19, "op": "topk", "row": 17, "mode": "learned"}
    {"id": 20, "op": "refresh_towers"}
    {"id": 8, "op": "update",
     "add_nodes": [{"type": "author", "id": "a_new", "label": "A. New"}],
     "add_edges": [{"rel": "author_of", "src": "a_new", "dst": "paper_7"}],
     "remove_edges": [{"rel": "author_of", "src_row": 4, "dst_row": 17}]}

``topk`` accepts an optional ``mode`` (``"exact"`` | ``"ann"`` |
``"learned"``, default the service's ``--topk-mode``): ``ann`` answers
through the MIPS candidate index plus an exact f64 rerank, and silently
degrades to the exact path (counted per reason) for rows the index
cannot vouch for; ``learned`` answers through the two-tower candidates
plus the same exact rerank, degrading ann-then-exact.
``refresh_index`` re-embeds the delta-staled index rows and advances
the index epoch to the service's token; ``refresh_towers`` re-embeds
the delta-staled and appended rows through the towers' inductive
encoder (cold start) and advances the towers' epoch.

``batch_blocks`` answers one row block of a batch campaign
(router/batch.py). The partition-exchange ops (``resolve``,
``part_info``, ``set_colsum``, ``tile_pull``, ``partial_topk``,
``partial_scores``, ``part_update``) are served by partition workers
(serving/partition.py) behind ``dpathsim-torch router --mode
partition``; a replica answers them (but ``resolve``) with a clean
per-request error.

A ``metapath`` field on ``topk`` or ``scores`` answers through that
closed metapath's engine (built on first use, bounded by
``--max-metapaths``); the ``compact`` op forces one background-style
compaction synchronously (re-encode with fresh pow-2 headroom, hot-swap,
token and caches preserved) and answers its accounting.

Three optional fields extend EVERY request, defaulted so clients that
never send them keep working unchanged:

- ``request_id`` — a caller-chosen globally-unique identity. Responses
  echo it, so retried/hedged dispatches can be deduplicated. Absent →
  responses omit it.
- ``deadline_ms`` — the caller's remaining time budget, counted from
  receipt of the request. An expired budget fails fast with
  ``deadline_exceeded`` instead of dispatching; the wait for a queued
  ``topk`` is clamped to it (:class:`~..resilience.Deadline`).
- ``trace`` — distributed trace context: ``{"trace_id": ...,
  "span_id": ...}`` re-roots this request's spans under the sender's
  span, and ``{"sampled": false}`` propagates a dropped-head sampling
  decision (zero spans for the request). The ``trace`` *op* returns
  this process's span ring (+ pid + wall anchor).

The ``health`` op is the heartbeat: O(1) liveness plus the load signals
a router routes on (queue depth, in-flight count) and the
replica-consistency token ``(base_fp, delta_seq)``. The ``drain`` op is
the in-band graceful shutdown (the protocol twin of SIGTERM): stop
accepting, complete in-flight, exit 0.

The ``update`` op is the delta-ingestion entry point (data/delta.py): a
warm service absorbs the batch without a reload — O(Δ) patch of the
factor on the card, no new compile, and only the affected rows' cache
entries are invalidated. Its result reports which path ran (``mode``:
``delta`` | ``rebuild``), how many score rows the change touched, and
the new chained fingerprint.

The ``metrics`` op is the live-aggregates endpoint (obs/): per-op
latency quantiles (p50/p95/p99 from the streaming histograms), cache
hit rates per tier, and the full registry snapshot. Every op's wall
time is observed into ``dpathsim_request_seconds{op=...}`` here.

Responses mirror the id and carry ``ok``; successes add ``result`` and
``latency_ms``, failures add ``error``. Unknown ops / bad JSON are
per-request errors, never process exits: one malformed client line must
not take the service down for everyone else.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import IO

from ..obs.metrics import get_registry
from ..obs.trace import from_wire, get_tracer
from ..resilience import Deadline, DeadlineExceeded
from ..utils.logging import runtime_event
from .service import PathSimService

_QUERY_KEYS = ("source", "source_id", "row")

# The op vocabulary the port serves (``shutdown`` and ``drain`` are
# handled by serve_loop itself).
PROTOCOL_OPS = frozenset({
    "ping", "stats", "metrics", "health", "invalidate", "topk",
    "refresh_index", "refresh_towers", "update", "scores", "trace",
    "compact", "batch_blocks",
    # partition-mode exchange ops: served by PartitionService workers
    # behind `dpathsim-torch router --mode partition`; on a replica
    # service they fail as clean per-request errors. part_update /
    # set_colsum are MUTATING_OPS in the worker runtime, so routed-delta
    # retries dedup by request_id.
    "resolve", "part_info", "set_colsum", "tile_pull", "partial_topk",
    "partial_scores", "part_update",
})

_PARTITION_OPS = ("part_info", "set_colsum", "tile_pull", "partial_topk",
                  "partial_scores", "part_update")

# op → (latency-histogram cell, error-counter cell), bound on first use
# so the steady-state path pays cell increments, never registry/label
# lookups (the bind-once discipline service.py and cache.py follow).
# Op cardinality is the fixed protocol vocabulary plus whatever unknown
# op names clients send — those error out and are rare by definition.
_OP_CELLS: dict[str, tuple] = {}


def _op_cells(op: str) -> tuple:
    cells = _OP_CELLS.get(op)
    if cells is None:
        reg = get_registry()
        cells = _OP_CELLS[op] = (
            reg.histogram(
                "dpathsim_request_seconds",
                "protocol request wall time by op",
            ).labels(op=op),
            reg.counter(
                "dpathsim_request_errors_total", "failed protocol requests"
            ).labels(op=op),
        )
    return cells


def _hit_rate(hits: int, misses: int) -> float | None:
    total = hits + misses
    return None if total == 0 else round(hits / total, 6)


def metrics_snapshot(service: PathSimService) -> dict:
    """The ``metrics`` op payload: derived summaries first (what an
    operator asks for), full registry snapshot last (what tooling
    scrapes). The cache hit counts come from the same per-instance
    counters ``stats()`` reports, so the two views can never disagree."""
    reg = get_registry()
    snap = reg.snapshot()  # once: the op summaries below read from it
    ops: dict[str, dict] = {}
    fam = snap.get("dpathsim_request_seconds")
    if fam:
        for entry in fam["values"]:
            if not entry["count"]:
                continue  # bound-but-never-observed cell: no summary
            name = entry["labels"].get("op", "?")
            ops[name] = {
                "count": entry["count"],
                "p50_ms": round(entry["p50"] * 1e3, 4),
                "p95_ms": round(entry["p95"] * 1e3, 4),
                "p99_ms": round(entry["p99"] * 1e3, 4),
                "mean_ms": round(
                    entry["sum"] / max(entry["count"], 1) * 1e3, 4
                ),
            }
    rc, tc = service.result_cache, service.tile_cache
    return {
        "ops": ops,
        "caches": {
            "result": {
                "hits": rc.hits, "misses": rc.misses,
                "hit_rate": _hit_rate(rc.hits, rc.misses),
            },
            "tile": {
                "hits": tc.hits, "misses": tc.misses,
                "hit_rate": _hit_rate(tc.hits, tc.misses),
            },
        },
        "enabled": {
            "metrics": reg.enabled, "tracing": get_tracer().enabled,
        },
        "registry": snap,
    }


def _dispatch_op(
    service: PathSimService, op: str, req: dict,
    deadline: Deadline | None = None,
):
    """The op table: one request's work, exceptions propagating to the
    caller's per-request error envelope."""
    if op == "ping":
        return {"pong": True}
    if op == "stats":
        return service.stats()
    if op == "metrics":
        return metrics_snapshot(service)
    if op == "health":
        return service.health()
    if op == "invalidate":
        service.invalidate()
        return {"invalidated": True}
    if op == "topk":
        kwargs = {key: req.get(key) for key in _QUERY_KEYS}
        if all(v is None for v in kwargs.values()):
            raise KeyError("topk needs one of source / source_id / row")
        hits = service.topk(
            k=req.get("k"),
            timeout_s=deadline.remaining_s() if deadline else None,
            mode=req.get("mode"),
            metapath=req.get("metapath"),
            **kwargs,
        )
        return {
            "topk": [
                {"id": i, "label": lab, "score": s} for i, lab, s in hits
            ]
        }
    if op == "refresh_index":
        return service.refresh_index()
    if op == "refresh_towers":
        # absorb the patched graph into the learned tier (re-embed the
        # stale + appended rows through the inductive encoder)
        return service.refresh_towers()
    if op == "compact":
        # force one background-style compaction synchronously
        # (serving/compact.py): re-encode with fresh pow-2 headroom,
        # hot-swap under the swap lock, token and caches preserved.
        # Idempotent by construction — re-running it re-encodes the
        # same logical graph — so router retries need no dedup.
        return service.compact()
    if op == "trace":
        # the span-ring scrape; bounded payload — the ring can hold
        # 200k spans and the wire is one JSON line
        limit = req.get("limit")
        return get_tracer().export_state(
            limit=int(limit) if limit else 20_000
        )
    if op == "update":
        from ..data.delta import delta_from_records

        delta = delta_from_records(
            service.hin,
            add_nodes=req.get("add_nodes", ()),
            add_edges=req.get("add_edges", ()),
            remove_edges=req.get("remove_edges", ()),
        )
        return service.update(delta, want_rows=bool(req.get("want_rows")))
    if op == "scores":
        row = service.resolve(
            source=req.get("source"),
            source_id=req.get("source_id"),
            row=req.get("row"),
            metapath=req.get("metapath"),
        )
        return {
            "row": row,
            "scores": service.scores_index(
                row, metapath=req.get("metapath")
            ).tolist(),
        }
    if op == "batch_blocks":
        # one batch-campaign row block (router/batch.py's scheduler):
        # answered through the same backend calls the oracle parity
        # tests pin, fenced on the campaign's (base_fp, delta_seq)
        handler = getattr(service, "batch_blocks", None)
        if handler is None:
            raise KeyError(
                "op 'batch_blocks' requires a replica service "
                "(partition workers serve partial_* ops only)"
            )
        return handler(req)
    if op == "resolve":
        # label/id → global dense row; any worker answers (partition
        # workers keep FULL index spaces — only edges are sliced)
        return {
            "row": service.resolve(
                source=req.get("source"),
                source_id=req.get("source_id"),
                row=req.get("row"),
            )
        }
    if op in _PARTITION_OPS:
        return _partition_op(service, op, req)
    raise KeyError(f"unknown op {op!r}")


def _partition_op(service, op: str, req: dict):
    """Partition-exchange dispatch: a clean per-request error on a
    replica service (the op vocabulary is shared; the capability is
    not)."""
    handler = getattr(service, op, None)
    if handler is None:
        raise KeyError(
            f"op {op!r} requires a partition worker "
            "(dpathsim-torch worker --partition-index ...)"
        )
    return handler(req)


def handle_request(service: PathSimService, req: dict) -> dict:
    """One request dict → one response dict (transport-free core)."""
    rid = req.get("id")
    op = req.get("op", "topk")
    # the end-to-end time budget, counted from receipt; expired budgets
    # fail fast — dispatching work nobody is still waiting for wastes
    # the very capacity an overloaded caller needs back
    deadline = Deadline.from_ms(req.get("deadline_ms"))
    request_id = req.get("request_id")
    latency_cell, error_cell = _op_cells(op)
    t0 = time.perf_counter()
    try:
        if deadline is not None and deadline.expired:
            raise DeadlineExceeded(
                f"deadline_ms={req.get('deadline_ms')} expired on arrival"
            )
        # protocol-level span: the outermost segment of a served
        # request's trace (the serve.request root parents under it on
        # query ops). A ``trace`` field on the wire re-roots it under
        # the SENDING process's span; a ``sampled: false`` context
        # suppresses every span downstream (the head decision travels
        # with the request).
        rctx = from_wire(req.get("trace"))
        tracer = get_tracer()
        activation = (
            tracer.activate(rctx) if rctx is not None
            else contextlib.nullcontext()
        )
        with activation:
            with tracer.span("serve.op", op=op):
                result = _dispatch_op(service, op, req, deadline=deadline)
    except Exception as exc:  # per-request failure, not process failure
        latency_cell.observe(time.perf_counter() - t0)
        error_cell.inc()
        msg = exc.args[0] if exc.args else repr(exc)
        resp = {"id": rid, "ok": False, "error": str(msg)}
        if getattr(exc, "transient", False):
            # e.g. a partition worker mid colsum-exchange: the router
            # should retry/fence, not surface a hard failure
            resp["transient"] = True
        if isinstance(exc, DeadlineExceeded) or (
            deadline is not None and deadline.expired
        ):
            # machine-readable cause: a router must know "out of time"
            # (do NOT reroute) from "this replica failed" (do reroute)
            resp["deadline_exceeded"] = True
        if request_id is not None:
            resp["request_id"] = request_id
        return resp
    latency_s = time.perf_counter() - t0
    latency_cell.observe(latency_s)
    resp = {
        "id": rid,
        "ok": True,
        "result": result,
        "latency_ms": round(latency_s * 1e3, 3),
    }
    if request_id is not None:
        resp["request_id"] = request_id
    return resp


def _drain(service: PathSimService, reason: str) -> None:
    """The graceful-drain epilogue, shared by the in-band ``drain`` op
    and SIGTERM: wait out the in-flight pipeline (every accepted request
    completes — the zero-lost-request half of the contract), then emit
    the final accounting event so the metrics channel records the
    shutdown state."""
    service.coalescer.drain()
    runtime_event(
        "serve_drain",
        reason=reason,
        requests=service.coalescer.dispatched_requests,
        shed=service.coalescer.shed_count,
    )


def serve_loop(
    service: PathSimService, in_stream: IO[str], out_stream: IO[str]
) -> int:
    """Read JSONL requests until EOF or a ``shutdown`` op; write one
    JSONL response per request, flushed per line (a pipe peer must see
    the answer without waiting for buffering).

    SIGTERM (via the resilience preemption handler, installed by the
    serve CLI) and the in-band ``drain`` op both trigger a *graceful
    drain*: the current request completes and is answered, the coalescer pipeline
    flushes, a final ``serve_drain`` event lands on the metrics channel,
    and the loop returns 0 — no accepted request is ever dropped. Lines
    not yet read when the drain begins were never accepted; the closed
    response stream is the client's signal to fail them over. (A drain
    latched mid-wait takes effect at the next protocol event — the next
    request line or EOF — because the reader blocks in the stream.)"""
    from ..resilience import preemption_handler

    for line in in_stream:
        if preemption_handler.requested():
            # a signal landed while we were blocked on the read: the
            # just-read line was never accepted — drain and exit before
            # handling it (its sender sees EOF, not silence-then-drop)
            _drain(service, preemption_handler.reason or "signal")
            return 0
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as exc:
            resp = {"id": None, "ok": False, "error": f"bad request: {exc}"}
            out_stream.write(json.dumps(resp) + "\n")
            out_stream.flush()
            continue
        if req.get("op") == "shutdown":
            out_stream.write(
                json.dumps({"id": req.get("id"), "ok": True,
                            "result": {"shutdown": True}}) + "\n"
            )
            out_stream.flush()
            return 0
        if req.get("op") == "drain":
            out_stream.write(
                json.dumps({"id": req.get("id"), "ok": True,
                            "result": {"draining": True}}) + "\n"
            )
            out_stream.flush()
            _drain(service, "drain op")
            return 0
        out_stream.write(json.dumps(handle_request(service, req)) + "\n")
        out_stream.flush()
        if preemption_handler.requested():
            # SIGTERM during the request just answered: it completed
            # and its response is flushed — now drain and exit
            _drain(service, preemption_handler.reason or "signal")
            return 0
    return 0
