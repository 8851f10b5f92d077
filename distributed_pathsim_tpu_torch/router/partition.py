"""PartitionRouter: one graph sharded across many workers.

The replica :class:`~.core.Router` fans whole queries over N *replicas*
of one graph — the largest servable HIN is whatever fits one worker.
This router shards the graph itself: each worker holds a contiguous
row-range slice of the half-chain factor (plus chained mirrors of its
successors' ranges, so every range survives worker deaths), and a query
becomes a two-phase scatter-gather over the wire:

1. **tile_pull** — fetch the source row's factor tile ``C[s, :]`` from
   a holder of the owning range (the boundary exchange; the
   torch-sharded backend's ring step does the same between shards, this
   is that exchange lifted onto the router's wire);
2. **partial_topk / partial_scores** — scatter the tile to ONE holder
   per range; each scores its own rows locally and returns top-k
   candidates (exact integer counts + denominators, oracle tie order);
3. **merge** — the router recomputes every candidate's f64 score with
   ``ops.pathsim.score_candidates`` and selects with
   ``topk_from_candidate_scores`` (the exact-merge primitives). Since
   each range's true top-k is a prefix of its local order, the union of
   per-range top-k covers the global top-k, and every number entering
   the merge is an exact integer — the result is bit-identical to a
   single-host oracle, (−score, ascending col) ties included.

Robustness inherits the replica router's contracts one level down:

- **Zero lost requests**: every sub-request (tile or partial) of a
  pending query is re-dispatched to another holder of its range when a
  worker dies mid-batch; chained replication guarantees a surviving
  holder for every range up to ``replication − 1`` deaths.
- **Routed deltas**: an ``update`` broadcast becomes a two-phase routed
  delta — phase 1 (``part_update``) stages the row-filtered delta at
  every holder and returns per-range Δcolsum contributions; the router
  aggregates exactly one contribution per range (integer sums:
  holder-independent) and phase 2 (``set_colsum``) seals the new
  global denominators. Fencing is per-partition: each range carries a
  row epoch and the fleet a colsum epoch; a worker that missed a phase
  lags the head, is fenced from dispatch, and is caught up by ordered
  idempotent replay (request-id dedup at the worker).
- **Epoch-coherent answers**: every partial response carries the
  worker's sealed update seq; a scatter whose parts straddle an update
  is detected at merge and restarted — a query answers from ONE graph
  epoch, never a mix.
- **Observability**: the router emits the same request/latency metric
  families the replica router does (the SLO engine runs unchanged over
  the merged stream and judges the worst partition through the
  per-worker scrape), plus per-partition dispatch counters;
  slow/errored/failed-over requests land in the flight recorder. Every
  scatter opens a fleet-level root span and every sub-request carries
  its dispatch span's context on the wire, so a partition-mode request
  stitches into ONE cross-process trace
  (``collect_trace_parts``/``write_fleet_trace``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

import numpy as np

from concurrent.futures import Future

from ..data.partition import PartitionMap
from ..obs import fleet as obs_fleet
from ..obs.flight import FlightRecorder
from ..obs.metrics import get_registry
from ..obs.slo import SLOEngine, default_specs
from ..obs.trace import get_tracer, to_wire
from ..ops import pathsim
from ..resilience import Deadline, inject
from ..utils.logging import runtime_event
from .core import DOWN, SUSPECT, UP, RouterShed
from .transport import WorkerGone

# client ops this router scatters over partitions (a subset of
# serving.protocol.PROTOCOL_OPS, like core.ROUTED_OPS)
SCATTER_OPS = frozenset({"topk", "scores"})

# merge-time epoch-mismatch restarts before a query fails: each restart
# means an update sealed mid-scatter, so >3 in a row is a stuck fleet,
# not bad luck
_MAX_RESTARTS = 3


@dataclasses.dataclass
class PartitionRouterConfig:
    partitions: int = 2
    replication: int = 2
    heartbeat_interval_s: float = 0.25
    heartbeat_miss_limit: int = 4
    max_inflight: int = 512
    default_deadline_ms: float | None = None
    max_attempts: int = 4            # holders tried per sub-request
    update_timeout_s: float = 60.0
    drain_timeout_s: float = 30.0
    park_timeout_s: float = 10.0
    ready_timeout_s: float = 180.0
    scrape_interval_s: float = 5.0
    slo_specs: tuple = ()
    slow_ms: float | None = None
    flight_capacity: int = 256


class _PartWorker:
    __slots__ = (
        "wid", "index", "transport", "status", "last_pong",
        "applied_seq", "colsum_seq", "row_seq", "held", "ready",
        "catchup_active", "last_health", "pong_seq",
        "last_metrics", "metrics_seq", "metrics_mono",
    )

    def __init__(self, wid: str, index: int, transport):
        self.wid = wid
        self.index = index
        self.transport = transport
        self.status = UP
        self.last_pong = time.monotonic()
        self.applied_seq = 0
        self.colsum_seq = 0
        self.row_seq: dict[int, int] = {}
        self.held: tuple[int, ...] = ()
        self.ready = False
        self.catchup_active = False
        self.last_health: dict = {}
        self.pong_seq = 0
        self.last_metrics: dict | None = None
        self.metrics_seq = 0
        self.metrics_mono = 0.0


class _Scatter:
    """One pending client query across its sub-requests. ``assigned``
    maps a sub-request key — ``"rs"`` (resolve), ``"tl"`` (tile), or a
    range index — to the worker currently carrying it."""

    __slots__ = (
        "rid", "req", "op", "future", "row", "k", "deadline", "t0",
        "stage", "tile", "parts", "assigned", "tried", "failovers",
        "restarts", "parked", "span", "sub_spans",
    )

    def __init__(self, rid, req, op, future, row, k, deadline,
                 span=None):
        self.rid = rid
        self.req = req
        self.op = op
        self.future = future
        self.row = row
        self.k = k
        self.deadline = deadline
        self.t0 = time.monotonic()
        self.stage = "resolve" if row is None else "tile"
        self.tile: dict | None = None
        self.parts: dict[int, dict] = {}
        self.assigned: dict = {}
        self.tried: dict = {}
        self.failovers = 0
        self.restarts = 0
        self.parked = False
        # tracing: the fleet-level root span and one child span per
        # sub-request dispatch (resolve / tile_pull / partial per
        # range), each carried to its worker on the wire so a
        # partition-mode request renders as ONE Perfetto tree
        self.span = span
        self.sub_spans: dict = {}


class _Epoch:
    """One routed delta in the replay log: the phase wires (stable
    ``request_id`` per phase — what makes catch-up replays idempotent)
    and the ranges whose rows it re-encoded."""

    __slots__ = ("seq", "part_wire", "colsum_wire", "ranges", "rid")

    def __init__(self, seq, part_wire, colsum_wire, ranges, rid):
        self.seq = seq
        self.part_wire = part_wire
        self.colsum_wire = colsum_wire
        self.ranges = ranges
        self.rid = rid


class _Collector:
    """Fan-out ack collection for one broadcast phase."""

    def __init__(self, waiting):
        self._cv = threading.Condition()
        self.waiting = set(waiting)
        self.acks: dict[str, dict] = {}
        self.failures: dict[str, str] = {}

    def resolve(self, wid: str, obj: dict | None, error: str | None) -> None:
        with self._cv:
            if wid not in self.waiting:
                return
            self.waiting.discard(wid)
            if error is not None:
                self.failures[wid] = error
            else:
                self.acks[wid] = obj or {}
            if not self.waiting:
                self._cv.notify_all()

    def wait(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.waiting:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    for wid in list(self.waiting):
                        self.failures[wid] = "ack timeout"
                    self.waiting.clear()
                    return False
                self._cv.wait(remaining)
        return True


class PartitionRouter:
    """Owns P partition-worker transports (worker ``w{i}`` carries
    partition index ``i``) and the scatter-gather pending table.
    ``transports`` is ``{worker_id: transport}``; worker ids must be
    ``w0..w{P-1}`` so partition indices are unambiguous."""

    def __init__(self, transports: dict,
                 config: PartitionRouterConfig | None = None):
        if not transports:
            raise ValueError("partition router needs at least one worker")
        self.config = config or PartitionRouterConfig()
        if len(transports) != self.config.partitions:
            raise ValueError(
                f"{len(transports)} transports for "
                f"{self.config.partitions} partitions — partition mode "
                "runs exactly one worker per partition index"
            )
        self._lock = threading.RLock()
        self.workers: dict[str, _PartWorker] = {}
        for i in range(self.config.partitions):
            wid = f"w{i}"
            if wid not in transports:
                raise ValueError(f"missing transport for {wid}")
            self.workers[wid] = _PartWorker(wid, i, transports[wid])
        self.pmap: PartitionMap | None = None
        self.n = 0
        self.v = 0
        self._base_fp: str | None = None
        self._pending: dict[str, _Scatter] = {}
        self._epochs: list[_Epoch] = []
        self._compacted_to = 0
        self._head_seq = 0
        self._head_row_seq: dict[int, int] = {}
        self._rid_seq = itertools.count(1)
        self._hb_seq = itertools.count(1)
        self._mx_seq = itertools.count(1)
        # update ATTEMPTS get distinct request_ids (an aborted seq is
        # retried under a fresh attempt — reusing the id would let the
        # workers' dedup replay the aborted attempt's cached acks)
        self._attempt_seq = itertools.count(1)
        self._update_lock = threading.Lock()
        self._updating = False
        self._collectors: dict[str, _Collector] = {}
        self._draining = False
        self._closed = threading.Event()
        self._maintenance: threading.Thread | None = None
        reg = get_registry()
        self._m_requests = reg.counter(
            "dpathsim_router_requests_total",
            "router requests by outcome",
        )
        self._m_latency = reg.histogram(
            "dpathsim_router_request_seconds",
            "router submit-to-resolve latency by outcome",
        )
        self._m_failovers = reg.counter(
            "dpathsim_router_failovers_total",
            "re-dispatches after worker death/stall/retriable failure",
        )
        self._m_part_dispatch = reg.counter(
            "dpathsim_partition_dispatch_total",
            "partial sub-requests dispatched, by partition index",
        )
        self._m_restarts = reg.counter(
            "dpathsim_partition_epoch_restarts_total",
            "scatters restarted because an update sealed mid-flight",
        ).labels()
        specs = tuple(self.config.slo_specs) or default_specs()
        self.slo = SLOEngine(specs, on_alert=self._on_slo_alert)
        slow_ms = self.config.slow_ms
        if slow_ms is None:
            slow_ms = next(
                (s.threshold * 1e3 for s in specs
                 if s.kind == "latency" and s.threshold), 1000.0,
            )
        self._slow_s = float(slow_ms) / 1e3
        self.flight = FlightRecorder(self.config.flight_capacity)
        self._shutdown_dumped = False
        # optional shutdown artifact paths (set by the CLI): flight
        # records AND the stitched fleet trace — partition scatters
        # carry trace context on every sub-request wire, so a
        # partition-mode request is one connected cross-process tree
        self.flight_out: str | None = None
        self.fleet_trace_out: str | None = None
        self.trace_scrape_limit = 20_000

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        cfg = self.config
        for w in self.workers.values():
            w.transport.start(self._on_message, self._on_death)
        fps = {}
        for w in self.workers.values():
            info = w.transport.wait_ready(cfg.ready_timeout_s)
            fps[w.wid] = info.get("base_fp")
            self.n = max(self.n, int(info.get("n", 0)))
        base = next(iter(fps.values()))
        if any(fp != base for fp in fps.values()):
            raise ValueError(
                f"partitions disagree on the base graph: {fps} — every "
                "partition must slice the same dataset/config"
            )
        self._base_fp = base
        self.pmap = PartitionMap(n=max(self.n, 1), p=cfg.partitions)
        # transports are live (reader threads touch worker state under
        # the lock), so seed shared maps under it too
        with self._lock:
            self._head_row_seq = {g: 0 for g in range(cfg.partitions)}
        self._exchange_colsum()
        now = time.monotonic()
        with self._lock:
            for w in self.workers.values():
                w.last_pong = now
        self._maintenance = threading.Thread(
            target=self._maintenance_loop,
            name="pathsim-partrouter-maint", daemon=True,
        )
        self._maintenance.start()
        runtime_event(
            "partition_router_ready", partitions=cfg.partitions,
            replication=cfg.replication, n=self.n, v=self.v,
            fingerprint=base,
        )

    def _exchange_colsum(self) -> None:
        """Startup boundary exchange: pull every worker's per-range
        colsum contribution, aggregate exactly one per range (integer
        sums — any holder's contribution is bit-identical), broadcast
        the global colsum. Workers cannot score anything before this."""
        acks, _failures = self._broadcast(
            {"op": "part_info", "request_id": "pi0"}, "pi",
            timeout=self.config.update_timeout_s,
        )
        if not acks:
            raise RuntimeError("no partition answered part_info")
        by_range: dict[int, dict] = {}
        v = 0
        for wid in sorted(acks):
            result = acks[wid].get("result") or {}
            v = max(v, int(result.get("v") or 0))
            part = result.get("partition") or {}
            with self._lock:
                w = self.workers.get(wid)
                if w is not None:
                    w.held = tuple(int(g) for g in part.get("held") or ())
                    w.row_seq = {int(g): 0 for g in w.held}
            for g_str, payload in (result.get("colsum") or {}).items():
                g = int(g_str)
                # prefer the owner's contribution; any holder's is
                # bit-identical, so first-by-sorted-wid is fine too
                if g not in by_range or self.workers[wid].index == g:
                    by_range[g] = payload
        self.v = v
        missing = [
            g for g in range(self.config.partitions)
            if g not in by_range and self.pmap.range_of(g)[0]
            < self.pmap.range_of(g)[1]
        ]
        g_sum = np.zeros(max(v, 1), dtype=np.float64)
        for payload in by_range.values():
            cols = np.asarray(payload.get("cols") or [], dtype=np.int64)
            vals = np.asarray(payload.get("vals") or [], dtype=np.float64)
            g_sum[cols] += vals
        nz = np.flatnonzero(g_sum)
        wire = {
            "op": "set_colsum", "mode": "init", "request_id": "pc0",
            "cols": [int(c) for c in nz],
            "vals": [float(g_sum[c]) for c in nz],
        }
        acks, _failures = self._broadcast(
            wire, "ci", timeout=self.config.update_timeout_s,
        )
        with self._lock:
            for wid in acks:
                w = self.workers.get(wid)
                if w is not None:
                    w.ready = True
        if missing:
            # a range with rows but no contribution would silently
            # zero its denominators — refuse to serve that
            raise RuntimeError(
                f"no colsum contribution for ranges {missing}"
            )
        runtime_event(
            "partition_colsum_exchanged", v=self.v,
            nnz=int(nz.shape[0]), workers=sorted(acks), echo=False,
        )

    def _broadcast(self, wire: dict, tag: str, timeout: float,
                   targets=None) -> tuple[dict, dict]:
        """Send one request to every live worker (or ``targets``),
        collect acks. Returns ({wid: ok-response}, {wid: error})."""
        token = f"{tag}{next(self._mx_seq)}"  # no ':' — it delimits ids
        with self._lock:
            if targets is None:
                targets = [
                    w for w in self.workers.values()
                    if w.status != DOWN and w.transport.alive
                ]
            col = _Collector([w.wid for w in targets])
            self._collectors[token] = col
        try:
            for w in targets:
                per = dict(wire)
                per["id"] = f"cl:{token}:{w.wid}"
                try:
                    if tag in ("up", "cs"):
                        # the delta_broadcast chaos seam: an injected
                        # error means THIS partition misses the phase —
                        # it lags the head and is fenced until catch-up
                        # replay
                        inject.fire("delta_broadcast")
                    w.transport.send(per)
                except (inject.InjectedFault, WorkerGone) as exc:
                    col.resolve(w.wid, None, repr(exc))
            col.wait(timeout)
        finally:
            # exactly-once: an exception between registration and this
            # removal must not leave a dead collector entry that every
            # later _mark_down walks forever (EX003)
            with self._lock:
                self._collectors.pop(token, None)
        acks = {
            wid: obj for wid, obj in col.acks.items() if obj.get("ok")
        }
        failures = dict(col.failures)
        for wid, obj in col.acks.items():
            if not obj.get("ok"):
                failures[wid] = str(obj.get("error", "?"))
        return acks, failures

    def close(self) -> None:
        self._closed.set()
        for w in self.workers.values():
            w.transport.close()

    def drain(self) -> bool:
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + self.config.drain_timeout_s
        clean = True
        with self._lock:
            pending = len(self._pending)
        while time.monotonic() < deadline:
            with self._lock:
                pending = len(self._pending)
                if not pending and not self._updating:
                    break
            time.sleep(0.005)
        else:
            clean = False
        # dumps BEFORE the workers terminate: the stitched trace needs
        # one last span-ring scrape, and a drained worker can't answer
        self._shutdown_dumps()
        for w in self.workers.values():
            if w.transport.alive:
                try:
                    w.transport.terminate()
                except Exception:
                    pass
        runtime_event("partition_router_drain", clean=clean,
                      pending=pending)
        return clean

    def collect_trace_parts(self, timeout: float = 5.0) -> list[dict]:
        """The stitched-export inputs: this process's span ring plus a
        ``trace``-op scrape of every live partition worker (same
        contract as the replicate router's: a SIGKILLed worker's
        un-scraped spans are absence, not breakage)."""
        limit = self.trace_scrape_limit
        acks, _failures = self._broadcast(
            {"op": "trace", "limit": limit}, "tr", timeout=timeout,
        )
        parts = [{**get_tracer().export_state(limit=limit),
                  "process": "router"}]
        for wid in sorted(acks):
            result = acks[wid].get("result") or {}
            if "spans" in result:
                parts.append({**result, "process": f"worker {wid}"})
        return parts

    def write_fleet_trace(self, path: str,
                          parts: list[dict] | None = None) -> int:
        """One stitched Perfetto file for the partition fleet; returns
        the span-event count."""
        if parts is None:
            parts = self.collect_trace_parts()
        n = obs_fleet.write_fleet_trace(path, parts)
        runtime_event("fleet_trace_written", path=path, spans=n)
        return n

    def _shutdown_dumps(self) -> None:
        if self._shutdown_dumped:
            return
        self._shutdown_dumped = True
        if not (self.flight_out or self.fleet_trace_out):
            return
        try:
            parts = (
                self.collect_trace_parts()
                if get_tracer().enabled and self.fleet_trace_out
                else []
            )
            if self.flight_out:
                info = self.flight.dump(self.flight_out, parts)
                runtime_event("flight_dump", **info)
            if self.fleet_trace_out:
                self.write_fleet_trace(self.fleet_trace_out, parts=parts)
        except Exception as exc:
            runtime_event("fleet_dump_failed", error=repr(exc))

    # -- submission --------------------------------------------------------

    def submit(self, req: dict) -> Future:
        op = req.get("op", "topk")
        fut: Future = Future()
        with self._lock:
            draining = self._draining
        if draining:
            fut.set_result({"id": req.get("id"), "ok": False,
                            "error": "draining", "draining": True})
            return fut
        if op == "ping":
            fut.set_result({"id": req.get("id"), "ok": True,
                            "result": {"pong": True}})
            return fut
        if op in ("stats", "health"):
            fut.set_result({"id": req.get("id"), "ok": True,
                            "result": self.stats()})
            return fut
        if op == "fleet_metrics":
            resp = {"id": req.get("id"), "ok": True,
                    "result": self.fleet_metrics(
                        refresh=bool(req.get("refresh", True)))}
            if req.get("request_id") is not None:
                resp["request_id"] = req.get("request_id")
            fut.set_result(resp)
            return fut
        if op == "flight_dump":
            fut.set_result({"id": req.get("id"), "ok": True,
                            "result": self.flight.snapshot()})
            return fut
        if op == "update":
            return self._submit_update(req, fut)
        if op not in SCATTER_OPS:
            fut.set_result({"id": req.get("id"), "ok": False,
                            "error": f"unknown op {op!r}"})
            return fut
        # the fleet-level trace root: head sampling decides here, once
        # for the whole scatter — every sub-request wire propagates it
        root = get_tracer().start_span(
            "router.request", op=op, row=req.get("row"), mode="partition",
        )
        with self._lock:
            if len(self._pending) >= self.config.max_inflight:
                self._m_requests.inc(outcome="shed")
                get_tracer().finish(root, outcome="shed")
                self.flight.keep(["shed"], op=op, row=req.get("row"),
                                 where="admission")
                raise RouterShed(
                    f"router pending table at bound "
                    f"({self.config.max_inflight})"
                )
            rid = f"r{next(self._rid_seq)}"
            row = req.get("row")
            row = int(row) if row is not None else None
            k = int(req.get("k") or 10)
            deadline = Deadline.from_ms(
                req.get("deadline_ms", self.config.default_deadline_ms)
            )
            p = _Scatter(rid, req, op, fut, row, k, deadline, span=root)
            self._pending[rid] = p
        self._advance(p)
        return fut

    def request(self, req: dict, timeout: float = 60.0) -> dict:
        return self.submit(req).result(timeout=timeout)

    # -- scatter dispatch --------------------------------------------------

    def _holders(self, g: int) -> list[str]:
        """Preference-ordered worker ids holding range ``g``."""
        return [
            f"w{i}"
            for i in self.pmap.holders_of(g, self.config.replication)
        ]

    def _eligible(self, p: _Scatter, key, holders) -> tuple[str | None, str]:
        """Next worker for sub-request ``key``, under the lock."""
        tried = p.tried.setdefault(key, set())
        fenced = live = 0
        for wid in holders:
            w = self.workers.get(wid)
            if w is None or w.status != UP or not w.transport.alive:
                continue
            live += 1
            if wid in tried:
                continue
            if not w.ready or w.colsum_seq != self._head_seq:
                fenced += 1
                continue
            if isinstance(key, int):
                if self._head_row_seq.get(key, 0) != w.row_seq.get(key, -1):
                    fenced += 1
                    continue
            return wid, ""
        if fenced:
            return None, "fenced"
        if live:
            return None, "exhausted"
        return None, "no live holders"

    def _advance(self, p: _Scatter) -> None:
        """Dispatch whatever the scatter's current stage needs. Any
        sub-request that cannot be placed parks the whole query (a
        holder coming back, catching up, or an update sealing makes it
        placeable again)."""
        if p.deadline is not None and p.deadline.expired:
            self._fail(p, "deadline exceeded")
            return
        with self._lock:
            if p.rid not in self._pending:
                return
            if self._updating:
                p.parked = True
                return
        if p.stage == "resolve":
            self._dispatch_sub(
                p, "rs",
                [w.wid for w in self.workers.values()],
                {"op": "resolve",
                 "source": p.req.get("source"),
                 "source_id": p.req.get("source_id")},
            )
            return
        if p.stage == "tile":
            g0 = self.pmap.owner_of(p.row)
            self._dispatch_sub(
                p, "tl", self._holders(g0),
                {"op": "tile_pull", "row": p.row},
            )
            return
        # stage "parts": one partial per non-empty range not yet answered
        for g in range(self.config.partitions):
            lo, hi = self.pmap.range_of(g)
            if lo >= hi:
                continue
            with self._lock:
                have = g in p.parts or g in p.assigned
            if have:
                continue
            # per-op wires: partial_scores ignores row/k (the full
            # slice includes the self pair by definition), so sending
            # them was dead weight the schema gate flags (WC103)
            if p.op == "topk":
                wire = {
                    "op": "partial_topk",
                    "range": g, "row": p.row, "k": p.k,
                    "cols": p.tile.get("cols"),
                    "vals": p.tile.get("vals"),
                    "d_source": p.tile.get("d_source"),
                }
            else:
                wire = {
                    "op": "partial_scores",
                    "range": g,
                    "cols": p.tile.get("cols"),
                    "vals": p.tile.get("vals"),
                    "d_source": p.tile.get("d_source"),
                }
            if not self._dispatch_sub(p, g, self._holders(g), wire):
                return  # parked or failed; stop fanning out

    def _dispatch_sub(self, p: _Scatter, key, holders, wire: dict) -> bool:
        """Place one sub-request; True if it went out (or the query is
        already resolved), False if the query parked/failed instead."""
        while True:
            if p.deadline is not None and p.deadline.expired:
                self._fail(p, "deadline exceeded")
                return False
            exhausted = False
            with self._lock:
                if p.rid not in self._pending:
                    return True
                tried = p.tried.setdefault(key, set())
                if len(tried) >= self.config.max_attempts:
                    exhausted = True
                    wid = None
                else:
                    wid, why = self._eligible(p, key, holders)
            if exhausted:
                # the replicate router's fail-fast bound, per
                # sub-request: a key refused by max_attempts distinct
                # holders fails instead of cycling forever
                self._fail(p, "max attempts exhausted")
                return False
            if wid is None:
                self._park_or_fail(p, why)
                return False
            tracer = get_tracer()
            with self._lock:
                if p.rid not in self._pending:
                    return True
                w = self.workers[wid]
                p.tried.setdefault(key, set()).add(wid)
                p.assigned[key] = wid
                attempt = None
                if p.span is not None:
                    # one span per sub-request dispatch, all siblings
                    # under the scatter root; a failed-over
                    # sub-request's earlier span seals as superseded
                    attempt = tracer.start_span(
                        "router.dispatch", parent=p.span.context,
                        worker=wid, sub=str(key), op=wire.get("op"),
                    )
                    tracer.finish(
                        p.sub_spans.pop(key, None), outcome="superseded"
                    )
                    p.sub_spans[key] = attempt
            out = dict(wire)
            sub = key if isinstance(key, str) else f"g{key}"
            out["id"] = f"q:{p.rid}:{sub}"
            out["request_id"] = f"{p.rid}.{sub}"
            if p.deadline is not None:
                out["deadline_ms"] = max(p.deadline.remaining_ms(), 0.0)
            if tracer.enabled:
                # the worker's serve.op span parents under THIS
                # dispatch span; a sampled-out root propagates the
                # drop so the fleet-wide head rate stays configured
                out["trace"] = to_wire(
                    attempt.context if attempt is not None else None,
                    sampled=attempt is not None,
                )
            if isinstance(key, int):
                self._m_part_dispatch.inc(partition=str(key))
            try:
                w.transport.send(out)
                return True
            except WorkerGone:
                with self._lock:
                    if p.assigned.get(key) == wid:
                        del p.assigned[key]
                    tracer.finish(
                        p.sub_spans.pop(key, None), outcome="send_failed"
                    )
                self._mark_down(wid, DOWN, "send failed")

    def _park_or_fail(self, p: _Scatter, verdict: str) -> None:
        if verdict in ("deadline exceeded",):
            self._fail(p, verdict)
            return
        with self._lock:
            recoverable = any(
                w.status in (UP, SUSPECT)
                and (w.transport.alive or w.status == SUSPECT)
                for w in self.workers.values()
            )
            if recoverable and p.rid in self._pending:
                p.parked = True
                runtime_event("partition_router_parked", rid=p.rid,
                              reason=verdict, echo=False)
                return
        self._fail(p, verdict)

    # -- responses ---------------------------------------------------------

    def _on_message(self, wid: str, obj: dict) -> None:
        if "event" in obj:
            return
        rid = obj.get("id")
        if not isinstance(rid, str):
            return
        if rid.startswith("hb:"):
            self._on_pong(wid, obj)
            return
        if rid.startswith("mx:"):
            self._on_metrics(wid, obj)
            return
        if rid.startswith("cl:"):
            token = rid.split(":", 2)[1]
            with self._lock:
                col = self._collectors.get(token)
            if col is not None:
                if obj.get("ok"):
                    col.resolve(wid, obj, None)
                else:
                    col.resolve(wid, None, str(obj.get("error", "?")))
            return
        if rid.startswith("cu:"):
            self._on_catchup_ack(wid, rid, obj)
            return
        if not rid.startswith("q:"):
            return
        parts = rid.split(":", 2)
        if len(parts) != 3:
            return
        _, prid, sub = parts
        with self._lock:
            p = self._pending.get(prid)
            if p is None:
                return
            key = int(sub[1:]) if sub.startswith("g") else sub
            if p.assigned.get(key) != wid:
                return  # a late answer from a failed-over sub-request
            del p.assigned[key]
            get_tracer().finish(
                p.sub_spans.pop(key, None),
                outcome="ok" if obj.get("ok") else "worker_error",
            )
        if not obj.get("ok"):
            retriable = bool(
                obj.get("shed") or obj.get("draining")
                or obj.get("transient")
            ) and not obj.get("deadline_exceeded")
            if not retriable:
                self._fail(p, str(obj.get("error", "worker error")))
                return
            p.failovers += 1
            self._m_failovers.inc(reason="worker_error")
            self._advance(p)
            return
        result = obj.get("result") or {}
        try:
            self._absorb(p, key, result)
        except Exception as exc:
            # a malformed partial (or a merge bug) must resolve the
            # scatter, not leak it: an unhandled exception here is
            # swallowed by the transport reader's guard and the client
            # future would hang forever
            self._fail(p, f"merge failed: {exc!r}")

    def _absorb(self, p: _Scatter, key, result: dict) -> None:
        """Fold one ok sub-response into the scatter and advance."""
        if key == "rs":
            row = result.get("row")
            if row is None:
                self._fail(p, "resolve returned no row")
                return
            p.row = int(row)
            p.stage = "tile"
            self._advance(p)
            return
        if key == "tl":
            if result.get("wrong_owner"):
                # label-resolved row landed off-owner: re-aim
                p.row = int(result.get("row", p.row or 0))
                p.stage = "tile"
                with self._lock:
                    p.tried.pop("tl", None)
                self._advance(p)
                return
            p.tile = result
            p.stage = "parts"
            self._advance(p)
            return
        with self._lock:
            p.parts[key] = result
            done = all(
                g in p.parts
                for g in range(self.config.partitions)
                if self.pmap.range_of(g)[0] < self.pmap.range_of(g)[1]
            )
        if done:
            self._merge(p)

    def _merge(self, p: _Scatter) -> None:
        """All parts in: verify epoch coherence, then the exact merge."""
        seqs = {p.tile.get("seq")} | {
            part.get("seq") for part in p.parts.values()
        }
        if len(seqs) > 1:
            # an update sealed mid-scatter: restart from the tile so
            # the answer comes from ONE graph epoch
            p.restarts += 1
            self._m_restarts.inc()
            if p.restarts > _MAX_RESTARTS:
                self._fail(p, "epoch moved during scatter (stuck)")
                return
            with self._lock:
                p.tile = None
                p.parts.clear()
                p.assigned.clear()
                p.tried.clear()
                p.stage = "tile"
            runtime_event("partition_epoch_restart", rid=p.rid,
                          echo=False)
            self._advance(p)
            return
        if p.op == "topk":
            resp = self._merge_topk(p)
        else:
            resp = self._merge_scores(p)
        self._resolve(p, resp)

    def _merge_topk(self, p: _Scatter) -> dict:
        cands = []
        for g in sorted(p.parts):
            cands.extend(p.parts[g].get("cands") or ())
        if not cands:
            return {"ok": True, "result": {"row": int(p.row), "topk": []}}
        m = np.asarray([[float(c.get("m") or 0.0) for c in cands]])
        d = np.asarray([[float(c.get("d") or 0.0) for c in cands]])
        cols = np.asarray(
            [[int(c.get("col") or 0) for c in cands]], dtype=np.int64
        )
        d_source = float(p.tile.get("d_source") or 0.0)
        scores = pathsim.score_candidates(
            m, np.asarray([d_source]), d, xp=np
        )
        vals, idxs = pathsim.topk_from_candidate_scores(scores, cols, p.k)
        ident = {
            int(c.get("col") or 0): (c.get("id"), c.get("label"))
            for c in cands
        }
        hits = []
        for v, j in zip(vals[0], idxs[0]):
            if not np.isfinite(v):
                continue
            i_id, lab = ident[int(j)]
            hits.append({"id": i_id, "label": lab, "score": float(v)})
        return {"ok": True, "result": {"row": int(p.row), "topk": hits}}

    def _merge_scores(self, p: _Scatter) -> dict:
        d_source = float(p.tile.get("d_source") or 0.0)
        chunks = []
        for g in sorted(p.parts):
            part = p.parts[g]
            counts = np.asarray(part.get("counts") or [],
                                dtype=np.float64)
            denoms = np.asarray(part.get("denoms") or [],
                                dtype=np.float64)
            if counts.shape[0] == 0:
                continue
            chunks.append(pathsim.score_candidates(
                counts[None, :], np.asarray([d_source]),
                denoms[None, :], xp=np,
            )[0])
        scores = (
            np.concatenate(chunks) if chunks
            else np.empty(0, dtype=np.float64)
        )
        return {"ok": True,
                "result": {"row": int(p.row), "scores": scores.tolist()}}

    def _resolve(self, p: _Scatter, resp: dict) -> None:
        elapsed = time.monotonic() - p.t0
        tracer = get_tracer()
        with self._lock:
            if self._pending.pop(p.rid, None) is None:
                return
            stale = list(p.sub_spans.values())
            p.sub_spans.clear()
        # seal the trace: outstanding sub-request spans (failed-over
        # stragglers) close as superseded, then the root carries the
        # outcome — one complete tree per scatter
        for span in stale:
            tracer.finish(span, outcome="superseded")
        tracer.finish(p.span, outcome="ok" if resp.get("ok") else "error")
        client = dict(resp)
        client["id"] = p.req.get("id")
        client["request_id"] = p.rid
        client["latency_ms"] = round(elapsed * 1e3, 3)
        if p.failovers:
            client["failovers"] = p.failovers
        outcome = "ok" if resp.get("ok") else "error"
        self._m_requests.inc(outcome=outcome)
        self._m_latency.observe(elapsed, outcome=outcome)
        reasons = []
        if outcome == "error":
            reasons.append("error")
        if resp.get("shed"):
            reasons.append("shed")
        if p.failovers:
            reasons.append("failover")
        if p.restarts:
            reasons.append("epoch_restart")
        if elapsed > self._slow_s:
            reasons.append("slow")
        if reasons:
            self.flight.keep(
                reasons, rid=p.rid, op=p.op, row=p.row,
                elapsed_ms=round(elapsed * 1e3, 3), outcome=outcome,
                error=resp.get("error"), failovers=p.failovers,
            )
        p.future.set_result(client)

    def _fail(self, p: _Scatter, error: str, **flags) -> None:
        resp = {"ok": False, "error": error, **flags}
        if error == "deadline exceeded":
            resp["deadline_exceeded"] = True
        self._resolve(p, resp)

    # -- death, heartbeats, catch-up ---------------------------------------

    def _on_death(self, wid: str, reason: str) -> None:
        self._mark_down(wid, DOWN, reason)

    def _mark_down(self, wid: str, status: str, reason: str) -> None:
        orphans: list[tuple[_Scatter, object]] = []
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status == DOWN or w.status == status:
                return
            w.status = status
            for p in self._pending.values():
                for key, awid in list(p.assigned.items()):
                    if awid == wid:
                        del p.assigned[key]
                        orphans.append((p, key))
        runtime_event(
            "partition_worker_down", worker_id=wid, status=status,
            reason=reason, orphaned=len(orphans),
        )
        get_registry().counter(
            "dpathsim_router_worker_down_total",
            "workers marked down/suspect, by cause",
        ).inc(status=status)
        # also resolve any collector still waiting on this worker
        with self._lock:
            cols = list(self._collectors.values())
        for col in cols:
            col.resolve(wid, None, reason)
        seen = set()
        for p, _key in orphans:
            if p.rid in seen:
                continue
            seen.add(p.rid)
            p.failovers += 1
            self._m_failovers.inc(reason=reason.split(" ")[0] or "death")
            self._advance(p)

    def _maintenance_loop(self) -> None:
        cfg = self.config
        interval = cfg.heartbeat_interval_s
        tick = max(min(interval, 0.05), 0.005)
        next_probe = 0.0
        next_scrape = 0.0
        while not self._closed.wait(tick):
            now = time.monotonic()
            if now >= next_probe:
                next_probe = now + interval
                self._probe_workers(now)
            if cfg.scrape_interval_s and now >= next_scrape:
                next_scrape = now + cfg.scrape_interval_s
                try:
                    merged, _ = obs_fleet.merge_registry_snapshots(
                        self.metric_parts()
                    )
                    self.slo.observe(merged, now)
                except Exception as exc:
                    runtime_event("fleet_slo_error", error=repr(exc))
                self._scrape_workers()
            self._retry_parked(now)

    def _probe_workers(self, now: float) -> None:
        cfg = self.config
        for w in list(self.workers.values()):
            if w.status == DOWN or not w.transport.alive:
                continue
            try:
                inject.fire("heartbeat")
                w.transport.send(
                    {"id": f"hb:{w.wid}:{next(self._hb_seq)}",
                     "op": "health"}
                )
            except inject.InjectedFault:
                pass
            except WorkerGone:
                self._mark_down(w.wid, DOWN, "heartbeat send failed")
                continue
            silence = now - w.last_pong
            if (
                w.status == UP
                and silence > cfg.heartbeat_interval_s
                * cfg.heartbeat_miss_limit
            ):
                self._mark_down(
                    w.wid, SUSPECT,
                    f"stall {silence * 1e3:.0f}ms without pong",
                )

    def _on_pong(self, wid: str, obj: dict) -> None:
        if not obj.get("ok"):
            return
        result = obj.get("result") or {}
        part = result.get("partition") or {}
        catchup_from = None
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status == DOWN:
                return
            w.last_pong = time.monotonic()
            w.last_health = result
            w.pong_seq += 1
            if part:
                w.applied_seq = int(part.get("update_seq") or 0)
                w.colsum_seq = int(part.get("colsum_seq") or 0)
                w.ready = bool(part.get("ready"))
                w.held = tuple(int(g) for g in part.get("held") or ())
                w.row_seq = {
                    int(g): int(s)
                    for g, s in (part.get("row_seq") or {}).items()
                }
            if w.status == SUSPECT:
                w.status = UP
                runtime_event("partition_worker_up", worker_id=wid,
                              echo=False)
            if (
                w.applied_seq < self._head_seq
                and not w.catchup_active
                and not self._updating
            ):
                w.catchup_active = True
                catchup_from = w.applied_seq + 1
            self._compact_epochs()
        if catchup_from is not None:
            self._send_catchup(wid, catchup_from, phase="pu")

    def _compact_epochs(self) -> None:
        """Drop the replay payloads of routed-delta epochs every live
        worker has sealed — called under the lock whenever a worker's
        applied seq advances. Without this a long-lived router under
        sustained deltas retains every update's full edge lists
        forever. Entries keep their slot (seq indexing stays stable);
        only a worker behind the horizon would need a compacted
        payload, and the horizon IS the min live applied seq."""
        live = [
            w.applied_seq for w in self.workers.values()
            if w.status != DOWN
        ]
        if not live:
            return
        horizon = min(min(live), len(self._epochs))
        for i in range(self._compacted_to, horizon):
            self._epochs[i].part_wire = None
            self._epochs[i].colsum_wire = None
        self._compacted_to = max(self._compacted_to, horizon)

    def _send_catchup(self, wid: str, seq: int, phase: str) -> None:
        """Ordered idempotent replay of a missed routed delta: phase
        ``pu`` (part_update) then ``cs`` (set_colsum), each carrying
        the ORIGINAL request_id so the worker's dedup replays cached
        acks for anything it already applied."""
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status != UP:
                if w is not None:
                    w.catchup_active = False
                return
            if not 1 <= seq <= len(self._epochs):
                w.catchup_active = False
                return
            epoch = self._epochs[seq - 1]
            base = (
                epoch.part_wire if phase == "pu" else epoch.colsum_wire
            )
            if base is None:
                # compacted: shouldn't happen (the horizon tracks the
                # slowest LIVE worker) — leave the replica fenced and
                # say so rather than replaying garbage
                w.catchup_active = False
                runtime_event(
                    "partition_catchup_impossible", worker_id=wid,
                    seq=seq,
                )
                return
            wire = dict(base)
            wire["id"] = f"cu:{wid}:{phase}:{seq}"
        runtime_event("partition_catchup", worker_id=wid, seq=seq,
                      phase=phase, echo=False)
        try:
            w.transport.send(wire)
        except WorkerGone:
            self._mark_down(wid, DOWN, "catchup send failed")

    def _on_catchup_ack(self, wid: str, rid: str, obj: dict) -> None:
        try:
            _, _, phase, seq_s = rid.split(":", 3)
            seq = int(seq_s)
        except ValueError:
            return
        if not obj.get("ok"):
            with self._lock:
                w = self.workers.get(wid)
                if w is not None:
                    w.catchup_active = False
            runtime_event("partition_catchup_failed", worker_id=wid,
                          seq=seq, phase=phase,
                          error=str(obj.get("error", "?")))
            return
        if phase == "pu":
            self._send_catchup(wid, seq, phase="cs")
            return
        next_seq = None
        with self._lock:
            w = self.workers.get(wid)
            if w is None:
                return
            w.applied_seq = max(w.applied_seq, seq)
            w.colsum_seq = max(w.colsum_seq, seq)
            result = obj.get("result") or {}
            for g, s in (result.get("row_seq") or {}).items():
                w.row_seq[int(g)] = int(s)
            if w.applied_seq < self._head_seq:
                next_seq = w.applied_seq + 1
            else:
                w.catchup_active = False
            self._compact_epochs()
        if next_seq is not None:
            self._send_catchup(wid, next_seq, phase="pu")

    def _retry_parked(self, now: float) -> None:
        ready: list[_Scatter] = []
        with self._lock:
            if self._updating:
                return
            for p in self._pending.values():
                if p.parked:
                    ready.append(p)
        for p in ready:
            if p.deadline is not None and p.deadline.expired:
                self._fail(p, "deadline exceeded")
                continue
            if (
                p.deadline is None
                and now - p.t0 > self.config.park_timeout_s
            ):
                self._fail(p, "no live holders")
                continue
            with self._lock:
                if p.rid not in self._pending:
                    continue
                p.parked = False
                # a resurrected/caught-up holder deserves a fresh try
                for key in list(p.tried):
                    if key not in p.assigned:
                        p.tried[key] = set()
            self._advance(p)

    # -- routed deltas -----------------------------------------------------

    def _submit_update(self, req: dict, fut: Future) -> Future:
        """The two-phase routed delta, serialized. Runs the exchange on
        a helper thread so the submitting client is not blocked inside
        the router lock; the returned future resolves when phase 2 is
        sealed (or the update times out)."""
        threading.Thread(
            target=self._run_update, args=(req, fut),
            name="pathsim-partrouter-update", daemon=True,
        ).start()
        return fut

    def _run_update(self, req: dict, fut: Future) -> None:
        cfg = self.config
        with self._update_lock:
            with self._lock:
                self._updating = True
                seq = self._head_seq + 1
            attempt = next(self._attempt_seq)
            try:
                part_wire = {
                    "op": "part_update", "seq": seq,
                    "attempt": attempt,
                    "request_id": f"pu{attempt}",
                    "add_nodes": req.get("add_nodes") or (),
                    "add_edges": req.get("add_edges") or (),
                    "remove_edges": req.get("remove_edges") or (),
                }
                acks, failures = self._broadcast(
                    part_wire, "up", timeout=cfg.update_timeout_s,
                )
                if not acks:
                    # surface the workers' own refusal (e.g. "edge
                    # deltas only"), not just the empty-ack fact
                    why = next(iter(failures.values()), "no live workers")
                    fut.set_result({
                        "id": req.get("id"), "ok": False,
                        "error": f"update applied on no partition: "
                                 f"{why}",
                        "detail": failures,
                    })
                    return
                # COVERAGE: every non-empty range must have an acked
                # holder, else that range's Δcolsum contribution (and
                # its row re-encode) would be silently lost — sealing
                # would fork the head from the true graph. Abort: the
                # stage mutated nothing, the client retries cleanly.
                covered: set[int] = set()
                for wid in acks:
                    result = acks[wid].get("result") or {}
                    covered.update(
                        int(g) for g in result.get("held") or ()
                    )
                uncovered = [
                    g for g in range(cfg.partitions)
                    if self.pmap.range_of(g)[0] < self.pmap.range_of(g)[1]
                    and g not in covered
                ]
                if uncovered:
                    self._broadcast(
                        {"op": "set_colsum", "mode": "abort",
                         "seq": seq, "attempt": attempt,
                         "request_id": f"pa{attempt}"},
                        "cs", timeout=cfg.update_timeout_s,
                        targets=[
                            self.workers[wid] for wid in acks
                            if self.workers[wid].transport.alive
                        ],
                    )
                    runtime_event(
                        "partition_update_aborted", seq=seq,
                        attempt=attempt, uncovered=uncovered,
                    )
                    fut.set_result({
                        "id": req.get("id"), "ok": False,
                        "error": (
                            "update aborted: range(s) "
                            f"{uncovered} have no live, current "
                            "holder — retry when the fleet recovers"
                        ),
                        "transient": True,
                    })
                    return
                by_range: dict[int, dict] = {}
                ranges: set[int] = set()
                re_encoded = 0
                for wid in sorted(acks):
                    result = acks[wid].get("result") or {}
                    re_encoded = max(
                        re_encoded, int(result.get("re_encoded") or 0)
                    )
                    ranges.update(
                        int(g) for g in result.get("affected_ranges")
                        or ()
                    )
                    for g_str, payload in (
                        result.get("contrib") or {}
                    ).items():
                        g = int(g_str)
                        if g not in by_range or (
                            self.workers[wid].index == g
                        ):
                            by_range[g] = payload
                dg = np.zeros(max(self.v, 1), dtype=np.float64)
                for payload in by_range.values():
                    cols = np.asarray(payload.get("cols") or [],
                                      dtype=np.int64)
                    vals = np.asarray(payload.get("vals") or [],
                                      dtype=np.float64)
                    dg[cols] += vals
                nz = np.flatnonzero(dg)
                colsum_wire = {
                    "op": "set_colsum", "mode": "delta", "seq": seq,
                    "attempt": attempt,
                    "request_id": f"pc{attempt}",
                    "cols": [int(c) for c in nz],
                    "vals": [float(dg[c]) for c in nz],
                }
                targets = [
                    self.workers[wid] for wid in acks
                    if self.workers[wid].status == UP
                    and self.workers[wid].transport.alive
                ]
                acks2, _failures2 = self._broadcast(
                    colsum_wire, "cs", timeout=cfg.update_timeout_s,
                    targets=targets,
                )
                with self._lock:
                    self._epochs.append(_Epoch(
                        seq=seq, part_wire=part_wire,
                        colsum_wire=colsum_wire,
                        ranges=tuple(sorted(ranges)), rid=f"u{seq}",
                    ))
                    self._head_seq = seq
                    for g in ranges:
                        if g in self._head_row_seq:
                            self._head_row_seq[g] += 1
                    for wid in acks2:
                        w = self.workers.get(wid)
                        if w is None:
                            continue
                        w.applied_seq = seq
                        w.colsum_seq = seq
                        result2 = acks2[wid].get("result") or {}
                        for g, s in (
                            result2.get("row_seq") or {}
                        ).items():
                            w.row_seq[int(g)] = int(s)
                    sealed = sorted(acks2)
                    lagging = sorted(
                        w.wid for w in self.workers.values()
                        if w.status != DOWN and w.applied_seq < seq
                    )
                    self._compact_epochs()
                runtime_event(
                    "partition_update", seq=seq, sealed=len(sealed),
                    lagging=lagging, re_encoded=re_encoded,
                    ranges=sorted(ranges),
                )
                fut.set_result({
                    "id": req.get("id"), "ok": bool(sealed),
                    "result": {
                        "mode": "routed-delta", "seq": seq,
                        "sealed": sealed, "lagging": lagging,
                        "re_encoded_rows": re_encoded,
                        "affected_ranges": sorted(ranges),
                        "base_fp": self._base_fp,
                        "delta_seq": seq,
                    },
                })
            except Exception as exc:  # surface, never hang the client
                fut.set_result({
                    "id": req.get("id"), "ok": False,
                    "error": f"routed update failed: {exc!r}",
                })
                runtime_event("partition_update_error", error=repr(exc))
            finally:
                with self._lock:
                    self._updating = False

    # -- observability -----------------------------------------------------

    def _scrape_workers(self) -> None:
        for w in list(self.workers.values()):
            if w.status == DOWN or not w.transport.alive:
                continue
            try:
                w.transport.send(
                    {"id": f"mx:{w.wid}:{next(self._mx_seq)}",
                     "op": "metrics"}
                )
            except WorkerGone:
                continue

    def _on_metrics(self, wid: str, obj: dict) -> None:
        if not obj.get("ok"):
            return
        result = obj.get("result") or {}
        registry = result.get("registry")
        if not isinstance(registry, dict):
            return
        with self._lock:
            w = self.workers.get(wid)
            if w is None:
                return
            w.last_metrics = registry
            w.metrics_seq += 1
            w.metrics_mono = time.monotonic()

    def metric_parts(self) -> dict:
        parts = {"router": get_registry().snapshot()}
        with self._lock:
            for wid, w in self.workers.items():
                if w.last_metrics is not None:
                    parts[wid] = w.last_metrics
        return parts

    def _on_slo_alert(self, info: dict) -> None:
        runtime_event(
            "slo_alert", slo=info["slo"], kind=info["kind"],
            objective=info["objective"],
            burn={k: round(v, 3) for k, v in info["burn"].items()},
        )

    def fleet_metrics(self, refresh: bool = True,
                      timeout: float = 5.0) -> dict:
        if refresh:
            with self._lock:
                seq0 = {w.wid: w.metrics_seq
                        for w in self.workers.values()}
            self._scrape_workers()
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    done = all(
                        w.status == DOWN or not w.transport.alive
                        or w.metrics_seq > seq0.get(wid, 0)
                        for wid, w in self.workers.items()
                    )
                if done:
                    break
                time.sleep(0.005)
        parts = self.metric_parts()
        merged, unmergeable = obs_fleet.merge_registry_snapshots(parts)
        return {
            "router": self.stats()["router"],
            "merged": merged,
            "unmergeable": unmergeable,
            "workers_scraped": sorted(k for k in parts if k != "router"),
            "slo": self.slo.snapshot(),
            "flight": {
                "kept_total": self.flight.kept_total,
                "dropped": self.flight.dropped,
                "capacity": self.flight.capacity,
            },
        }

    def worker_health(self, wid: str, timeout: float = 10.0) -> dict:
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status == DOWN:
                return {}
            seq0 = w.pong_seq
        try:
            w.transport.send(
                {"id": f"hb:{wid}:{next(self._hb_seq)}", "op": "health"}
            )
        except WorkerGone:
            return {}
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if w.pong_seq > seq0:
                    return dict(w.last_health)
            time.sleep(0.005)
        return {}

    def stats(self) -> dict:
        with self._lock:
            return {
                "router": {
                    "mode": "partition",
                    "partitions": self.config.partitions,
                    "replication": self.config.replication,
                    "workers": {
                        w.wid: {
                            "status": w.status,
                            "partition": w.index,
                            "held": list(w.held),
                            "applied_seq": w.applied_seq,
                            "lag": self._head_seq - w.applied_seq,
                            "ready": w.ready,
                            "row_seq": {
                                str(g): s
                                for g, s in sorted(w.row_seq.items())
                            },
                        }
                        for w in self.workers.values()
                    },
                    "pending": len(self._pending),
                    "epochs": self._head_seq,
                    "head_row_seq": {
                        str(g): s
                        for g, s in sorted(self._head_row_seq.items())
                    },
                    "n": self.n,
                    "v": self.v,
                    "draining": self._draining,
                    "obs": {
                        "slo_alerts": dict(self.slo.alert_counts),
                        "flight_kept": self.flight.kept_total,
                        "flight_dropped": self.flight.dropped,
                    },
                },
            }
