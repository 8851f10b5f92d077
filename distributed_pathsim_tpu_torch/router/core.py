"""The router core: fan requests over worker replicas, lose nothing.

One :class:`Router` owns N worker transports and gives upstream clients
the same JSONL protocol one ``dpathsim-torch serve`` process speaks — with
one process no longer being one failure domain. The design center is
*robustness*, wired through the existing resilience primitives:

- **Routing** (hashring.py): consistent-hash-by-row for cache affinity
  (the same row keeps hitting the replica whose tiers hold it), or
  contiguous row ranges; either yields a deterministic preference order
  that failover, hedging, and fencing all walk.
- **Failure detection**: per-worker heartbeats (``health`` op — pongs
  carry queue depth and the consistency token) catch *death* and
  *stalls* (miss limit exceeded → the worker is routed around and its
  in-flight work re-dispatched); transport EOF/broken-pipe catches
  death instantly. A stall-suspected worker that pongs again is
  readmitted — suspicion is not a death sentence.
- **Zero lost requests**: every admitted request lives in the pending
  table until exactly one response resolves it. A worker dying
  mid-batch re-dispatches its pending work to a surviving replica;
  retried work is idempotent (dedup by ``request_id`` at both ends —
  the worker replays mutation acks, the router keeps only the first
  answer).
- **Hedged requests**: a query in flight longer than the hedge
  threshold gets a duplicate sent to the next replica in preference
  order; first answer wins, the loser's arrival is counted and
  dropped. This bounds the p99 a stalled-but-not-dead replica causes.
- **Deadlines**: the protocol's ``deadline_ms`` budget is re-computed
  at every (re)dispatch — a failover or hedge never grants more time
  than the caller has left, and an expired budget fails fast instead
  of burning a replica (resilience.Deadline).
- **Admission**: the pending table is bounded; past it, submissions
  shed (:class:`RouterShed`) — and a worker that sheds locally pushes
  the request to the next replica, so the router only sheds when every
  replica is saturated.
- **Delta fencing**: ``update`` broadcasts carry the chained
  ``(base_fp, delta_seq)`` token. The router records each epoch's
  affected-row set; a replica that missed a broadcast is *fenced* —
  never handed a query for an affected row — until catch-up (ordered
  replay of the missed updates, idempotent by request id) brings its
  token to the head. The set is the served metapath's; a request
  naming a ``metapath`` can change outside it, so while any fence is
  active it goes only to caught-up replicas. No stale row can escape.

Chaos seams: ``heartbeat`` (a probe that never happened) and
``delta_broadcast`` (a worker missing an update) fire here;
``worker_dispatch`` fires in the worker (worker.py).

**Fleet observability plane**: the router is where the
fleet's N per-process truths become one. Every routed request gets a
fleet-level root span whose per-attempt dispatch spans (primary /
hedge / failover, siblings) carry their context to the workers on the
wire — one stitched cross-process trace per request. The maintenance
loop scrapes each worker's ``metrics`` op and merges the registries
EXACTLY (same bucket edges ⇒ bucket-wise sums, obs/fleet.py), the SLO
engine (obs/slo.py) evaluates declarative objectives over the merged
stream with multi-window burn-rate alerts, and a tail-sampling flight
recorder (obs/flight.py) retroactively keeps every slow / errored /
shed / hedged / failed-over request — dumped via the
``flight_dump`` op and at SIGTERM drain, while the workers can still
answer the final span-ring scrape.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future

from ..obs import fleet as obs_fleet
from ..obs.flight import FlightRecorder
from ..obs.metrics import get_registry
from ..obs.slo import SLOEngine, default_specs
from ..obs.trace import get_tracer, to_wire
from ..resilience import Deadline, inject
from ..utils.logging import runtime_event
from .hashring import make_policy
from .transport import WorkerGone

ROUTED_OPS = frozenset({"topk", "scores"})

# worker statuses
UP = "up"
SUSPECT = "suspect"      # heartbeat-missed: routed around, resurrectable
DOWN = "down"            # transport-dead: gone for good
DRAINING = "draining"    # autoscale drain: routed around, never readmitted


class RouterShed(RuntimeError):
    """Admission refused: the router's pending table is at its bound
    (or every replica is saturated)."""


@dataclasses.dataclass
class RouterConfig:
    routing: str = "hash"            # hash | range
    vnodes: int = 64
    max_inflight: int = 512          # admission bound on pending requests
    default_deadline_ms: float | None = None
    heartbeat_interval_s: float = 0.25
    heartbeat_miss_limit: int = 4    # unanswered intervals before SUSPECT
    hedge_ms: float | None = 100.0   # None disables hedged requests
    worker_queue_limit: int = 256    # per-replica saturation threshold
    max_attempts: int = 4            # distinct replicas tried per request
    update_timeout_s: float = 60.0
    drain_timeout_s: float = 30.0
    # how long a request may sit PARKED (no replica currently eligible:
    # every candidate suspected or fenced) before it fails; a transient
    # all-suspect blip — e.g. a stalled box starving every worker of
    # CPU for a second — must not turn into client-visible errors
    park_timeout_s: float = 10.0
    # -- fleet observability -------------------------------------------
    # metrics scrape cadence: the maintenance loop pulls each worker's
    # `metrics` op and merges the registries exactly (0 disables; the
    # satellite artifact forwarding still leaves per-worker files)
    scrape_interval_s: float = 5.0
    # declarative SLO specs evaluated over the merged stream; () ships
    # the defaults (availability / p99 latency / update-visible
    # staleness, the ann recall floor, and the learned cold-start
    # floor; obs/slo.py)
    slo_specs: tuple = ()
    # flight-recorder tail threshold: a request slower than this is
    # kept even if nothing else went wrong. None derives it from the
    # latency SLO's threshold (the p99 target IS the tail definition)
    slow_ms: float | None = None
    flight_capacity: int = 256
    # span-ring scrape bound per worker (trace op payload)
    trace_scrape_limit: int = 20_000
    # -- firehose update pipelining (router/firehose.py) ---------------
    # bounded update-queue admission: >0 routes ``update`` ops through
    # the coalescing pump; past the bound submitters get an immediate
    # ``backpressure`` error (the update-side shed signal). 0 keeps
    # the legacy one-broadcast-per-update path.
    update_queue: int = 0
    # max queued updates folded into ONE broadcast (the product-rule
    # ΔC composes; conflicting windows split automatically)
    update_coalesce: int = 8
    # how long the pump lingers for more queued updates before
    # broadcasting what it has
    update_flush_ms: float = 5.0
    # keep every epoch's replay payload even after all live replicas
    # pass it — required for autoscale: a freshly SPAWNED worker boots
    # the base graph and must replay the full epoch chain to catch up
    retain_replay: bool = False


class _WorkerState:
    __slots__ = (
        "wid", "transport", "status", "epoch", "queue_depth",
        "last_pong", "assigned", "catchup_active", "token",
        "last_health", "pong_seq", "last_metrics", "metrics_seq",
        "metrics_mono", "trace_part", "trace_seq",
    )

    def __init__(self, wid: str, transport):
        self.wid = wid
        self.transport = transport
        self.status = UP
        self.epoch = 0               # index into the router's epoch log
        self.queue_depth = 0
        self.last_pong = time.monotonic()
        self.assigned: set[str] = set()   # request ids in flight here
        self.catchup_active = False
        self.token: tuple[str, int] | None = None
        self.last_health: dict = {}
        self.pong_seq = 0
        # fleet observability: the last scraped registry snapshot (the
        # merge input), the last scraped span-ring export, and their
        # reply sequence counters (waited scrapes poll on these)
        self.last_metrics: dict | None = None
        self.metrics_seq = 0
        self.metrics_mono = 0.0
        self.trace_part: dict | None = None
        self.trace_seq = 0


class _Pending:
    __slots__ = (
        "rid", "req", "key", "row", "future", "deadline", "tried",
        "assigned", "hedged", "hedge_sent", "t0", "failovers", "parked",
        "span", "attempt_spans",
    )

    def __init__(self, rid: str, req: dict, key, row, future, deadline,
                 span=None):
        self.rid = rid
        self.req = req
        self.key = key
        self.row = row
        self.future = future
        self.deadline = deadline
        self.tried: list[str] = []
        self.assigned: set[str] = set()
        self.hedged = False      # hedge CONSIDERED (one shot per request)
        self.hedge_sent = False  # hedge actually dispatched
        self.failovers = 0
        self.parked = False
        self.t0 = time.monotonic()
        # tracing: the fleet-level root span and one child span per
        # dispatch ATTEMPT (primary / hedge / failover) — siblings
        # under the root, each carried to a worker on the wire so its
        # subtree grows there. None when tracing is off or this
        # request's head was sampled out.
        self.span = span
        self.attempt_spans: dict[str, object] = {}


class _Epoch:
    """One entry of the delta log: the consistency token after this
    update, the wire request to replay for catch-up, and the rows it
    affected (None = all rows; epoch 0 is the base graph)."""

    __slots__ = ("token", "wire_req", "affected", "rid")

    def __init__(self, token, wire_req=None, affected=None, rid=None):
        self.token = tuple(token)
        self.wire_req = wire_req
        self.affected = affected
        self.rid = rid


class _UpdatePending:
    __slots__ = ("rid", "client_id", "future", "waiting", "acks",
                 "failures", "t0", "epoch_index", "first_result", "wire",
                 "span", "target_spans")

    def __init__(self, rid, client_id, future, waiting, wire, span=None):
        self.rid = rid
        self.client_id = client_id
        self.future = future
        self.waiting: set[str] = set(waiting)
        self.acks: dict[str, dict] = {}
        self.failures: dict[str, str] = {}
        self.t0 = time.monotonic()
        self.epoch_index: int | None = None
        self.first_result: dict | None = None
        self.wire = wire  # replayable request (catch-up; same request_id)
        # tracing: root span for the broadcast + one child per target
        # replica (the wire carries each child's context, so the
        # worker-side delta application stitches under it)
        self.span = span
        self.target_spans: dict[str, object] = {}


class Router:
    """Owns worker transports and the pending table. ``transports`` is
    ``{worker_id: transport}`` (not yet started); :meth:`start` brings
    them up, verifies they serve the same graph, and starts the
    heartbeat/hedge maintenance thread."""

    def __init__(self, transports: dict, config: RouterConfig | None = None):
        if not transports:
            raise ValueError("router needs at least one worker")
        self.config = config or RouterConfig()
        self._lock = threading.RLock()
        self.workers: dict[str, _WorkerState] = {
            wid: _WorkerState(wid, t) for wid, t in transports.items()
        }
        self._pending: dict[str, _Pending] = {}
        self._updates: dict[str, _UpdatePending] = {}
        self._epochs: list[_Epoch] = []
        self._epoch_by_token: dict[tuple, int] = {}
        self._compacted_to = 0
        self._rid_seq = itertools.count(1)
        self._hb_seq = itertools.count(1)
        self._mx_seq = itertools.count(1)
        self._tr_seq = itertools.count(1)
        self._update_seq = itertools.count(1)
        self._update_lock = threading.Lock()  # serializes broadcasts
        self._draining = False
        self._closed = threading.Event()
        self._maintenance: threading.Thread | None = None
        # firehose update queue (config.update_queue > 0): submissions
        # land here; the pump thread drains, coalesces, broadcasts.
        # Guarded by _uq_cv's lock (its own leaf lock — the pump must
        # be able to block for arrivals without holding _lock).
        self._uq_cv = threading.Condition()
        self._uq: list[tuple[dict, Future]] = []
        self._uq_pump: threading.Thread | None = None
        self.updates_coalesced = 0   # updates folded into fewer wires
        self.update_broadcasts = 0   # coalesced broadcasts sent
        self.update_backpressure = 0
        self.policy = None
        self.n = 0
        # counters (per-process registry; the router is one per process)
        reg = get_registry()
        self._m_requests = reg.counter(
            "dpathsim_router_requests_total",
            "router requests by outcome",
        )
        self._m_failovers = reg.counter(
            "dpathsim_router_failovers_total",
            "re-dispatches after worker death/stall/retriable failure",
        )
        self._m_hedges = reg.counter(
            "dpathsim_router_hedges_total", "hedged duplicate dispatches"
        ).labels()
        self._m_dups = reg.counter(
            "dpathsim_router_dup_responses_total",
            "late/duplicate worker responses dropped by request-id dedup",
        ).labels()
        self._m_fence_skips = reg.counter(
            "dpathsim_router_fence_skips_total",
            "routing decisions that skipped a fenced replica",
        ).labels()
        # where the queries went: primary, hedge and failover sends
        # alike, per replica (the load split a routing policy produced)
        self._m_dispatches = reg.counter(
            "dpathsim_router_dispatches_total",
            "query dispatches sent, by worker",
        )
        self._m_latency = reg.histogram(
            "dpathsim_router_request_seconds",
            "router submit-to-resolve latency by outcome",
        )
        # firehose plane: queue depth is the autoscale/backpressure
        # signal, the coalesce counters are the pipelining evidence
        self._m_uq_depth = reg.gauge(
            "dpathsim_update_queue_depth",
            "updates admitted but not yet broadcast",
        ).labels()
        self._m_uq_backpressure = reg.counter(
            "dpathsim_update_backpressure_total",
            "updates refused at the queue bound",
        ).labels()
        self._m_uq_coalesced = reg.counter(
            "dpathsim_updates_coalesced_total",
            "updates folded into a shared broadcast",
        ).labels()
        self._m_uq_group = reg.histogram(
            "dpathsim_update_group_size",
            "updates per coalesced broadcast",
            bounds=tuple(float(1 << i) for i in range(9)),
        ).labels()
        # -- fleet observability plane ---------------------------------
        # SLO engine over the merged metric stream; alerts surface as
        # counters/gauges (inside the engine) AND router log events
        # (the callback — obs cannot emit events itself, layering)
        specs = tuple(self.config.slo_specs) or default_specs()
        self.slo = SLOEngine(specs, on_alert=self._on_slo_alert)
        # tail-sampling flight recorder: slow threshold from config,
        # else the latency SLO's own p99 target — "slower than the SLO
        # says p99 may be" IS the tail worth keeping
        slow_ms = self.config.slow_ms
        if slow_ms is None:
            slow_ms = next(
                (s.threshold * 1e3 for s in specs
                 if s.kind == "latency" and s.threshold), 1000.0,
            )
        self._slow_s = float(slow_ms) / 1e3
        self.flight = FlightRecorder(self.config.flight_capacity)
        self._shutdown_dumped = False
        # optional shutdown artifact paths (set by the CLI): written
        # during drain, BEFORE workers terminate — a SIGTERM must not
        # destroy the evidence it should be dumping
        self.flight_out: str | None = None
        self.fleet_trace_out: str | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, ready_timeout: float = 180.0) -> None:
        # membership is mutable under the lock (add/remove/reap_worker)
        # — snapshot the seed set; nothing else can mutate it before
        # start() returns, but the discipline is uniform
        with self._lock:
            seed = list(self.workers.values())
        for w in seed:
            w.transport.start(self._on_message, self._on_death)
        tokens = {}
        for w in seed:
            info = w.transport.wait_ready(ready_timeout)
            tokens[w.wid] = (info.get("base_fp"), int(info.get("delta_seq", 0)))
            w.token = tokens[w.wid]
            self.n = int(info.get("n", self.n))
        base = next(iter(tokens.values()))
        if any(t != base for t in tokens.values()):
            raise ValueError(
                f"workers disagree on the base graph: {tokens} — every "
                "replica must serve the same dataset/config"
            )
        # transports are live (reader threads deliver _on_message, which
        # touches the epoch log under the lock) — so hold it here too
        with self._lock:
            self._epochs.append(_Epoch(token=base))
            self._epoch_by_token[tuple(base)] = 0
        # pong clocks start NOW, not at construction: worker startup
        # (backend build + warmup) happens between __init__ and here,
        # and counting it as silence would mark every worker stalled
        # on the first probe
        now = time.monotonic()
        for w in seed:
            w.last_pong = now
        with self._lock:
            self._rebuild_policy()
        self._maintenance = threading.Thread(
            target=self._maintenance_loop, name="pathsim-router-maint",
            daemon=True,
        )
        self._maintenance.start()
        if self.config.update_queue > 0:
            self._uq_pump = threading.Thread(
                target=self._update_pump, name="pathsim-router-updates",
                daemon=True,
            )
            self._uq_pump.start()
        runtime_event(
            "router_ready", workers=len(seed), n=self.n,
            routing=self.config.routing, fingerprint=base[0],
        )

    def close(self) -> None:
        self._closed.set()
        with self._lock:
            targets = list(self.workers.values())
        for w in targets:
            w.transport.close()

    def drain(self) -> bool:
        """Graceful stop: reject new work, resolve everything pending,
        drain the workers. True if everything flushed in time."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + self.config.drain_timeout_s
        clean = True
        with self._lock:
            # seed the accounting: a zero/negative drain timeout must
            # still report the LIVE backlog it abandons
            pending, updates = len(self._pending), len(self._updates)
        while time.monotonic() < deadline:
            with self._lock:
                pending, updates = len(self._pending), len(self._updates)
            with self._uq_cv:
                queued = len(self._uq)
            if not pending and not updates and not queued:
                break
            time.sleep(0.005)
        else:
            clean = False
        # shutdown dumps happen HERE — pending flushed, workers still
        # alive — because the flight/trace artifacts need one last
        # span-ring scrape, and a terminated worker can't answer it
        self._shutdown_dumps()
        with self._lock:
            targets = list(self.workers.values())
        for w in targets:
            if w.transport.alive:
                try:
                    w.transport.terminate()
                except Exception:
                    pass
        runtime_event(
            "router_drain", clean=clean, pending=pending, updates=updates,
        )
        return clean

    # -- submission --------------------------------------------------------

    def submit(self, req: dict) -> Future:
        """Admit one protocol request; returns a Future of the response
        dict. Raises :class:`RouterShed` at the admission bound."""
        op = req.get("op", "topk")
        fut: Future = Future()
        with self._lock:
            draining = self._draining
        if draining:
            fut.set_result({
                "id": req.get("id"), "ok": False, "error": "draining",
                "draining": True,
            })
            return fut
        if op == "ping":
            fut.set_result({"id": req.get("id"), "ok": True,
                            "result": {"pong": True}})
            return fut
        if op in ("stats", "health"):
            fut.set_result({"id": req.get("id"), "ok": True,
                            "result": self.stats()})
            return fut
        if op == "update":
            if self.config.update_queue > 0:
                return self._enqueue_update(req, fut)
            return self._submit_update(req, fut)
        if op == "invalidate":
            return self._submit_invalidate(req, fut)
        if op == "fleet_metrics":
            resp = {"id": req.get("id"), "ok": True,
                    "result": self.fleet_metrics(
                        refresh=bool(req.get("refresh", True))
                    )}
            if req.get("request_id") is not None:
                resp["request_id"] = req["request_id"]
            fut.set_result(resp)
            return fut
        if op == "flight_dump":
            resp = {"id": req.get("id"), "ok": True,
                    "result": self.flight_dump(path=req.get("path"))}
            if req.get("request_id") is not None:
                resp["request_id"] = req["request_id"]
            fut.set_result(resp)
            return fut
        if op not in ROUTED_OPS:
            fut.set_result({"id": req.get("id"), "ok": False,
                            "error": f"unknown op {op!r}"})
            return fut
        # the fleet-level trace ROOT: head sampling decides here, once,
        # for the whole fleet — workers inherit the decision on the
        # wire (a sampled-out root sends {"sampled": false} downstream)
        root = get_tracer().start_span(
            "router.request", op=op, row=req.get("row"),
        )
        with self._lock:
            if len(self._pending) >= self.config.max_inflight:
                self._m_requests.inc(outcome="shed")
                runtime_event(
                    "router_shed", depth=self.config.max_inflight,
                    echo=False,
                )
                get_tracer().finish(root, outcome="shed")
                self.flight.keep(
                    ["shed"],
                    trace_id=root.trace_id if root else None,
                    op=op, row=req.get("row"), where="admission",
                )
                raise RouterShed(
                    f"router pending table at bound "
                    f"({self.config.max_inflight})"
                )
            rid = f"r{next(self._rid_seq)}"
            row = req.get("row")
            row = int(row) if row is not None else None
            key = row if row is not None else str(
                req.get("source") or req.get("source_id") or ""
            )
            deadline = Deadline.from_ms(
                req.get("deadline_ms", self.config.default_deadline_ms)
            )
            p = _Pending(rid, req, key, row, fut, deadline, span=root)
            self._pending[rid] = p
        verdict = self._dispatch(p)
        if verdict is not None:
            self._park_or_fail(p, verdict)
        return fut

    def request(self, req: dict, timeout: float = 60.0) -> dict:
        """Synchronous convenience: submit + wait."""
        return self.submit(req).result(timeout=timeout)

    # -- routing -----------------------------------------------------------

    def _eligible(self, p: _Pending, exclude) -> tuple[str | None, str]:
        """Pick the next replica for ``p`` under the lock. Returns
        (worker_id, reason-if-none)."""
        saturated = fenced = exhausted = 0
        # an epoch's affected set is the served metapath's: a secondary
        # metapath's answer can change outside it, so it is fenced as a
        # label query is (every lagging replica)
        fence_row = None if p.req.get("metapath") else p.row
        for wid in self.policy.preference(p.key):
            # the policy can briefly lag membership (reaped workers
            # stay in the last ring until a live set exists again) —
            # a missing id is simply not eligible
            w = self.workers.get(wid)
            if w is None or w.status != UP or not w.transport.alive:
                continue
            if wid in exclude:
                exhausted += 1  # alive, but this request already tried it
                continue
            if self._fenced(w, fence_row):
                fenced += 1
                self._m_fence_skips.inc()
                continue
            if w.queue_depth >= self.config.worker_queue_limit:
                saturated += 1
                continue
            return wid, ""
        if saturated:
            return None, "saturated"
        if fenced:
            return None, "fenced"
        if exhausted:
            # every live replica already refused this request (shed /
            # transient failure): surface that, don't park — the client
            # retrying later IS the backoff
            return None, "exhausted"
        return None, "no live workers"

    def _fenced(self, w: _WorkerState, row: int | None) -> bool:
        """Is this replica forbidden from answering for ``row``? True
        when it missed a delta whose affected set could cover the query
        (unknown rows — label queries — only go to caught-up replicas
        while any fence is active)."""
        head = len(self._epochs) - 1
        if w.epoch >= head:
            return False
        for epoch in self._epochs[w.epoch + 1:]:
            if epoch.affected is None or row is None:
                return True
            if row in epoch.affected:
                return True
        return False

    def _dispatch(self, p: _Pending, exclude: set | None = None,
                  kind: str | None = None) -> str | None:
        """Send ``p`` to the best eligible replica. None on success, an
        error string when no replica can take it. ``kind`` labels the
        attempt span ("hedge" from the hedge scan; otherwise derived:
        first try = "primary", re-dispatch = "failover")."""
        exclude = set(exclude or ())
        tracer = get_tracer()
        while True:
            if p.deadline is not None and p.deadline.expired:
                return "deadline exceeded"
            with self._lock:
                if p.rid not in self._pending:
                    return None  # already resolved (late failover race)
                if len(p.tried) >= self.config.max_attempts:
                    return "max attempts exhausted"
                wid, why = self._eligible(p, exclude | set(p.tried))
                if wid is None:
                    return why
                w = self.workers[wid]
                attempt = None
                if p.span is not None:
                    # one span per dispatch ATTEMPT, all siblings under
                    # the request root: a hedged-then-failed-over
                    # request reads as three parallel subtrees, each
                    # continuing into its worker's process
                    attempt = tracer.start_span(
                        "router.dispatch", parent=p.span.context,
                        worker=wid,
                        kind=kind or (
                            "primary" if not p.tried else "failover"
                        ),
                        attempt=len(p.tried),
                    )
                    stale = p.attempt_spans.pop(wid, None)
                    tracer.finish(stale, outcome="superseded")
                    p.attempt_spans[wid] = attempt
                p.tried.append(wid)
                p.assigned.add(wid)
                w.assigned.add(p.rid)
            wire = dict(p.req)
            wire["id"] = p.rid
            wire["request_id"] = p.rid
            if p.deadline is not None:
                wire["deadline_ms"] = max(p.deadline.remaining_ms(), 0.0)
            if tracer.enabled:
                # the worker parents under THIS attempt's span; a
                # sampled-out request propagates the drop instead, so
                # the fleet-wide rate stays exactly the configured 1/N
                wire["trace"] = to_wire(
                    attempt.context if attempt is not None else None,
                    sampled=attempt is not None,
                )
            try:
                w.transport.send(wire)
                self._m_dispatches.inc(worker=wid)
                return None
            except WorkerGone:
                with self._lock:
                    p.assigned.discard(wid)
                    w.assigned.discard(p.rid)
                    tracer.finish(
                        p.attempt_spans.pop(wid, None),
                        outcome="send_failed",
                    )
                self._mark_down(wid, DOWN, "send failed")
                exclude.add(wid)

    # -- resolution --------------------------------------------------------

    def _resolve(self, p: _Pending, resp: dict) -> None:
        elapsed = time.monotonic() - p.t0
        client_resp = dict(resp)
        client_resp["id"] = p.req.get("id")
        client_resp["request_id"] = p.rid
        outcome = "ok" if resp.get("ok") else "error"
        if p.failovers:
            client_resp["failovers"] = p.failovers
        if p.hedge_sent:
            client_resp["hedged"] = True
        self._m_requests.inc(outcome=outcome)
        self._m_latency.observe(elapsed, outcome=outcome)
        # seal the trace: outstanding attempt spans (hedge losers, the
        # straggler a failover abandoned) finish as superseded, then
        # the root closes with the outcome — one complete tree per
        # request no matter how many replicas touched it
        tracer = get_tracer()
        with self._lock:
            attempts = list(p.attempt_spans.values())
            p.attempt_spans.clear()
        for span in attempts:
            tracer.finish(span, outcome="superseded")
        tracer.finish(p.span, outcome=outcome)
        # tail sampling: the flight recorder keeps EVERY request whose
        # outcome is worth explaining, independent of the head-sampling
        # coin flip (obs/flight.py — 100% of errored/shed/hedged/
        # failed-over/slow/ann-degraded requests, by construction)
        ann_fb = (resp.get("result") or {}).get("ann_fallback") \
            if isinstance(resp.get("result"), dict) else None
        reasons = []
        if outcome == "error":
            reasons.append("error")
        if resp.get("shed"):
            reasons.append("shed")
        if p.hedge_sent:
            reasons.append("hedged")
        if p.failovers:
            reasons.append("failover")
        if ann_fb is not None:
            reasons.append("ann_fallback")
        if elapsed > self._slow_s:
            reasons.append("slow")
        if reasons:
            self.flight.keep(
                reasons,
                trace_id=p.span.trace_id if p.span is not None else None,
                rid=p.rid, op=p.req.get("op", "topk"), row=p.row,
                elapsed_ms=round(elapsed * 1e3, 3),
                workers=list(p.tried), outcome=outcome,
                error=resp.get("error"), ann_fallback=ann_fb,
                failovers=p.failovers,
            )
        p.future.set_result(client_resp)

    def _park_or_fail(self, p: _Pending, verdict: str) -> None:
        """No replica can take ``p`` right now. Hard verdicts fail;
        saturation sheds (when every replica is
        saturated the router says so immediately, it does not queue
        unboundedly); transient unavailability — every candidate
        suspected or fenced — PARKS the request for the maintenance
        loop to retry, because a worker coming back (pong) or catching
        up (delta replay) makes it dispatchable again."""
        if verdict in ("deadline exceeded", "max attempts exhausted"):
            self._fail(p, verdict)
            return
        if verdict == "saturated":
            self._fail(p, "all replicas saturated", shed=True)
            return
        if verdict == "exhausted":
            self._fail(p, "all replicas refused", shed=True)
            return
        with self._lock:
            recoverable = any(
                w.status in (UP, SUSPECT) and (
                    w.transport.alive or w.status == SUSPECT
                )
                for w in self.workers.values()
            )
            if recoverable and p.rid in self._pending:
                p.parked = True
                p.tried.clear()  # a resurrected replica gets a fresh try
                runtime_event("router_parked", rid=p.rid,
                              reason=verdict, echo=False)
                return
        self._fail(p, verdict)

    def _retry_parked(self, now: float) -> None:
        ready: list[_Pending] = []
        cfg = self.config
        with self._lock:
            for p in self._pending.values():
                if p.parked:
                    ready.append(p)
        for p in ready:
            if p.deadline is not None and p.deadline.expired:
                self._fail(p, "deadline exceeded")
                continue
            if (
                p.deadline is None
                and now - p.t0 > cfg.park_timeout_s
            ):
                self._fail(p, "no live workers")
                continue
            with self._lock:
                if p.rid not in self._pending:
                    continue
                p.parked = False
            verdict = self._dispatch(p)
            if verdict is not None:
                self._park_or_fail(p, verdict)

    def _fail(self, p: _Pending, error: str, **flags) -> None:
        with self._lock:
            if self._pending.pop(p.rid, None) is None:
                return
            for wid in p.assigned:
                self.workers[wid].assigned.discard(p.rid)
        resp = {"ok": False, "error": error, **flags}
        if error == "deadline exceeded":
            resp["deadline_exceeded"] = True
        if error in ("saturated", "shed"):
            resp["shed"] = True
        self._resolve(p, resp)

    def _on_message(self, wid: str, obj: dict) -> None:
        if "event" in obj:
            return  # ready/drained events: informational here
        rid = obj.get("id")
        if isinstance(rid, str) and rid.startswith("hb:"):
            self._on_pong(wid, obj)
            return
        if isinstance(rid, str) and rid.startswith("mx:"):
            self._on_metrics(wid, obj)
            return
        if isinstance(rid, str) and rid.startswith("tr:"):
            self._on_trace(wid, obj)
            return
        if isinstance(rid, str) and rid.startswith(("up:", "cu:")):
            self._on_update_ack(wid, rid, obj)
            return
        if isinstance(rid, str) and rid.startswith("inv:"):
            return  # broadcast invalidate ack: fire-and-forget

        with self._lock:
            p = self._pending.get(rid) if isinstance(rid, str) else None
            if p is not None and obj.get("ok"):
                del self._pending[rid]
                for awid in p.assigned:
                    self.workers[awid].assigned.discard(rid)
                # the winning attempt closes with the answer; the
                # losers are sealed as superseded inside _resolve
                get_tracer().finish(
                    p.attempt_spans.pop(wid, None), outcome="ok"
                )
        if p is None:
            # hedge loser, or a stall-suspected worker answering after
            # its work was already failed over — dedup: drop + count
            self._m_dups.inc()
            return
        if obj.get("ok"):
            self._resolve(p, obj)
            return
        # failed response: reroute retriable failures, surface the rest
        retriable = bool(
            obj.get("shed") or obj.get("draining") or obj.get("transient")
        ) and not obj.get("deadline_exceeded")
        if not retriable:
            with self._lock:
                if self._pending.pop(p.rid, None) is None:
                    return
                for awid in p.assigned:
                    self.workers[awid].assigned.discard(p.rid)
            self._resolve(p, obj)
            return
        with self._lock:
            p.assigned.discard(wid)
            self.workers[wid].assigned.discard(p.rid)
            get_tracer().finish(
                p.attempt_spans.pop(wid, None), outcome="worker_error"
            )
            if p.assigned:
                return  # a hedge is still in flight; let it race
        p.failovers += 1
        self._m_failovers.inc(reason="worker_error")
        verdict = self._dispatch(p)
        if verdict is not None:
            self._park_or_fail(p, verdict)

    def _on_death(self, wid: str, reason: str) -> None:
        self._mark_down(wid, DOWN, reason)

    def _mark_down(self, wid: str, status: str, reason: str) -> None:
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status == DOWN:
                return
            if w.status == status:
                return
            w.status = status
            orphans = [
                self._pending[rid]
                for rid in w.assigned
                if rid in self._pending
            ]
            w.assigned.clear()
            for p in orphans:
                p.assigned.discard(wid)
                get_tracer().finish(
                    p.attempt_spans.pop(wid, None), outcome="worker_down"
                )
        runtime_event(
            "router_worker_down", worker_id=wid, status=status,
            reason=reason, orphaned=len(orphans),
        )
        get_registry().counter(
            "dpathsim_router_worker_down_total",
            "workers marked down/suspect, by cause",
        ).inc(status=status)
        for p in orphans:
            with self._lock:
                if p.rid not in self._pending or p.assigned:
                    continue  # resolved meanwhile, or hedged elsewhere
            p.failovers += 1
            self._m_failovers.inc(reason=reason.split(" ")[0] or "death")
            verdict = self._dispatch(p)
            if verdict is not None:
                self._park_or_fail(p, verdict)

    # -- heartbeats, stall detection, hedging ------------------------------

    def _maintenance_loop(self) -> None:
        cfg = self.config
        interval = cfg.heartbeat_interval_s
        hedge_s = (cfg.hedge_ms / 1e3) if cfg.hedge_ms else None
        tick = min(interval, (hedge_s / 4) if hedge_s else interval)
        tick = max(tick, 0.005)
        next_probe = 0.0
        next_scrape = 0.0
        while not self._closed.wait(tick):
            now = time.monotonic()
            if now >= next_probe:
                next_probe = now + interval
                self._probe_workers(now)
            if cfg.scrape_interval_s and now >= next_scrape:
                next_scrape = now + cfg.scrape_interval_s
                # merge + SLO first, over the PREVIOUS round's replies
                # (a scrape is async — evaluating right after sending
                # would always read stale-by-one snapshots anyway, and
                # this way one tick is one coherent evaluate-then-ask)
                try:
                    self._evaluate_slo(now)
                except Exception as exc:
                    runtime_event("fleet_slo_error", error=repr(exc))
                self._scrape_workers()
            if hedge_s is not None:
                self._hedge_scan(now, hedge_s)
            self._retry_parked(now)
            self._sweep_updates(now)

    def _probe_workers(self, now: float) -> None:
        cfg = self.config
        with self._lock:
            targets = list(self.workers.values())
        for w in targets:
            if w.status == DOWN or not w.transport.alive:
                continue
            try:
                # the heartbeat seam: an injected error here is a probe
                # that never happened — enough of them and a healthy
                # worker goes SUSPECT (and comes back at the next pong)
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
                and silence > cfg.heartbeat_interval_s * cfg.heartbeat_miss_limit
            ):
                self._mark_down(
                    w.wid, SUSPECT,
                    f"stall {silence * 1e3:.0f}ms without pong",
                )

    def _on_pong(self, wid: str, obj: dict) -> None:
        if not obj.get("ok"):
            return
        result = obj.get("result") or {}
        token = (result.get("base_fp"), int(result.get("delta_seq", 0)))
        catchup_from = None
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status == DOWN:
                return
            w.last_pong = time.monotonic()
            w.queue_depth = int(result.get("queue_depth", 0))
            w.token = token
            w.last_health = result
            w.pong_seq += 1
            if w.status == SUSPECT:
                # the stall cleared: readmit (its in-flight work was
                # already failed over; dedup absorbs any late answers)
                w.status = UP
                runtime_event("router_worker_up", worker_id=wid,
                              echo=False)
            epoch = self._epoch_of(token)
            if epoch is None:
                # a token outside our history: divergent replica —
                # fence it from everything (epoch −1 predates epoch 0)
                w.epoch = -1
            else:
                w.epoch = max(w.epoch, epoch)
            if (
                w.epoch < len(self._epochs) - 1
                and not w.catchup_active
            ):
                w.catchup_active = True
                catchup_from = w.epoch + 1
            self._compact_epochs()
        if catchup_from is not None:
            self._send_catchup(wid, catchup_from)

    def _epoch_of(self, token) -> int | None:
        return self._epoch_by_token.get(tuple(token))

    def _compact_epochs(self) -> None:
        """Drop the replay payload (and affected set) of epochs every
        live replica has passed — called under the lock after an epoch
        advance. Without this a long-lived router retains every delta's
        full edge lists forever. Compacted entries keep their token
        (the epoch index must stay stable) with ``affected=None``,
        which only a divergent (epoch −1) replica would ever consult —
        and None means "all rows", exactly the conservative fence such
        a replica already gets."""
        if self.config.retain_replay:
            # autoscale mode: a spawned worker boots the base graph
            # (epoch 0) and catches up by replaying the WHOLE chain —
            # compacting any payload would strand it fenced forever
            return
        live = [
            w.epoch for w in self.workers.values()
            if w.status != DOWN and w.epoch >= 0
        ]
        if not live:
            return
        horizon = min(live)
        for i in range(max(self._compacted_to, 1), horizon + 1):
            self._epochs[i].wire_req = None
            self._epochs[i].affected = None
        self._compacted_to = max(self._compacted_to, horizon + 1)

    def _hedge_scan(self, now: float, hedge_s: float) -> None:
        stragglers: list[_Pending] = []
        with self._lock:
            for p in self._pending.values():
                if p.hedged or (now - p.t0) < hedge_s:
                    continue
                if p.deadline is not None and p.deadline.expired:
                    continue
                if len(p.assigned) != 1:
                    continue
                p.hedged = True  # one hedge attempt per request
                stragglers.append(p)
        for p in stragglers:
            # a failed hedge dispatch is not a request failure — the
            # original is still in flight; only a hedge that actually
            # went out is counted and flagged (a 1-replica router must
            # not fabricate hedge accounting)
            if self._dispatch(
                p, exclude=set(p.tried), kind="hedge"
            ) is None and (
                len(p.assigned) > 1
            ):
                p.hedge_sent = True
                self._m_hedges.inc()
                runtime_event(
                    "router_hedge", rid=p.rid, row=p.row,
                    waited_ms=round((now - p.t0) * 1e3, 1), echo=False,
                )

    # -- delta broadcast & fencing -----------------------------------------

    def _submit_update(self, req: dict, fut: Future) -> Future:
        tracer = get_tracer()
        with self._update_lock:
            seq = next(self._update_seq)
            urid = f"u{seq}"
            wire = dict(req)
            wire["request_id"] = urid
            wire["want_rows"] = True
            wire.pop("id", None)  # per-worker ids are stamped per send
            root = tracer.start_span("router.update", rid=urid)
            with self._lock:
                targets = [
                    w for w in self.workers.values()
                    if w.status == UP and w.transport.alive
                ]
                if not targets:
                    tracer.finish(root, outcome="no_workers")
                    fut.set_result({"id": req.get("id"), "ok": False,
                                    "error": "no live workers"})
                    return fut
                up = _UpdatePending(
                    urid, req.get("id"), fut, [w.wid for w in targets],
                    wire, span=root,
                )
                self._updates[urid] = up
            for w in targets:
                per_wire = dict(wire)
                per_wire["id"] = f"up:{w.wid}:{seq}"
                if root is not None:
                    # one broadcast span per replica, the wire carrying
                    # its context: every replica's delta application
                    # stitches under the ONE router.update tree
                    bspan = tracer.start_span(
                        "router.broadcast", parent=root.context,
                        worker=w.wid,
                    )
                    up.target_spans[w.wid] = bspan
                    per_wire["trace"] = to_wire(bspan.context)
                elif tracer.enabled:
                    per_wire["trace"] = to_wire(None, sampled=False)
                try:
                    # the delta_broadcast seam: an injected error means
                    # THIS worker misses the update — it will lag the
                    # token head and be fenced until catch-up
                    inject.fire("delta_broadcast")
                    w.transport.send(per_wire)
                except (inject.InjectedFault, WorkerGone) as exc:
                    self._update_failure(urid, w.wid, repr(exc))
        return fut

    # -- firehose update pipelining (router/firehose.py) -------------------

    def _enqueue_update(self, req: dict, fut: Future) -> Future:
        """Bounded admission for the firehose path: queue the update
        for the coalescing pump, or refuse immediately with a
        ``backpressure`` error — the update-side twin of query shed."""
        with self._uq_cv:
            if self._closed.is_set():
                fut.set_result({
                    "id": req.get("id"), "ok": False,
                    "error": "draining", "draining": True,
                })
                return fut
            if len(self._uq) >= self.config.update_queue:
                self.update_backpressure += 1
                self._m_uq_backpressure.inc()
                runtime_event(
                    "router_update_backpressure",
                    depth=self.config.update_queue, echo=False,
                )
                fut.set_result({
                    "id": req.get("id"), "ok": False,
                    "error": "update queue full",
                    "backpressure": True, "shed": True,
                })
                return fut
            self._uq.append((req, fut))
            self._m_uq_depth.set(len(self._uq))
            self._uq_cv.notify()
        return fut

    def _update_pump(self) -> None:
        """Drain → coalesce → broadcast, strictly in admission order.
        One pump thread per router, so coalesced broadcasts stay
        totally ordered (a delta chain applied out of order is a
        different graph)."""
        from .firehose import coalesce_update_groups

        flush_s = max(self.config.update_flush_ms, 0.0) / 1e3
        while not self._closed.is_set():
            with self._uq_cv:
                while not self._uq and not self._closed.is_set():
                    self._uq_cv.wait(0.2)
                if self._closed.is_set():
                    break
            if flush_s:
                time.sleep(flush_s)  # linger: let the window fill
            with self._uq_cv:
                batch = self._uq[:]
                del self._uq[:]
                self._m_uq_depth.set(0)
            if not batch:
                continue
            reqs = [r for r, _f in batch]
            futs = {id(r): f for r, f in batch}
            for group in coalesce_update_groups(
                reqs, max(self.config.update_coalesce, 1)
            ):
                self._broadcast_group(group, futs)
        # shutdown: whatever is still queued (enqueued mid-iteration,
        # or arriving between close() and the enqueue-side closed
        # check) must be resolved, never left hanging a caller's
        # fut.result()
        with self._uq_cv:
            leftover = self._uq[:]
            del self._uq[:]
            self._m_uq_depth.set(0)
        for req, fut in leftover:
            if not fut.done():
                fut.set_result({
                    "id": req.get("id"), "ok": False,
                    "error": "draining", "draining": True,
                })

    def _broadcast_group(self, group, futs: dict) -> None:
        """One coalesced broadcast; resolves every member future. A
        merged window the workers reject wholesale (e.g. an id/row
        aliased edge pair the record-level fold could not cancel)
        falls back to sequential per-member broadcasts — coalescing is
        a throughput optimization and must never fail an update the
        sequential path would have applied."""
        n = len(group.members)
        self.update_broadcasts += 1
        self._m_uq_group.observe(n)
        if n > 1:
            self.updates_coalesced += n
            self._m_uq_coalesced.inc(n)

        def broadcast_one(wire_req: dict) -> dict:
            inner: Future = Future()
            self._submit_update(dict(wire_req), inner)
            try:
                return inner.result(
                    timeout=self.config.update_timeout_s + 5.0
                )
            except Exception as exc:  # timeout: surface, don't hang
                return {"ok": False, "error": repr(exc)}

        resp = broadcast_one(group.merged_wire) if n > 1 else (
            broadcast_one(group.members[0])
        )
        if n > 1 and not resp.get("ok"):
            # fall back to sequential members ONLY on deterministic
            # wholesale rejection (every replica answered with an
            # error). An ack TIMEOUT is ambiguous — a slow replica may
            # yet apply the merge, and re-broadcasting members on top
            # would double-apply and fork its token off the epoch
            # history; surface the failure to the members instead.
            missed = (resp.get("detail") or {}).get("missed") or {}
            ambiguous = not missed or any(
                "timeout" in str(v) for v in missed.values()
            )
            if not ambiguous:
                runtime_event(
                    "router_coalesce_fallback", members=n,
                    error=str(resp.get("error", "?")),
                )
                for req in group.members:
                    r = broadcast_one(req)
                    fut = futs.get(id(req))
                    if fut is not None and not fut.done():
                        fut.set_result({**r, "id": req.get("id")})
                return
        for req in group.members:
            fut = futs.get(id(req))
            if fut is not None and not fut.done():
                out = dict(resp)
                out["id"] = req.get("id")
                if n > 1:
                    out["coalesced"] = n
                fut.set_result(out)

    def _on_update_ack(self, wid: str, rid: str, obj: dict) -> None:
        """An ``update`` response — from the broadcast (``up:``) or a
        catch-up replay (``cu:``). Either way the ack's token tells us
        where this replica now stands in the epoch log."""
        urid = f"u{rid.rsplit(':', 1)[1]}"
        is_catchup = rid.startswith("cu:")
        if not obj.get("ok"):
            if is_catchup:
                with self._lock:
                    w = self.workers.get(wid)
                    if w is not None:
                        # drop the in-progress flag: the next pong
                        # showing lag retries the replay
                        w.catchup_active = False
                runtime_event(
                    "router_catchup_failed", worker_id=wid, rid=urid,
                    error=obj.get("error", "?"),
                )
            else:
                self._update_failure(urid, wid, obj.get("error", "?"))
            return
        result = obj.get("result") or {}
        token = (result.get("base_fp"), int(result.get("delta_seq", 0)))
        finished = None
        next_catchup = None
        with self._lock:
            up = self._updates.get(urid)
            if up is not None:
                if up.epoch_index is None:
                    # first ack defines the epoch: its token and
                    # affected set (None = rebuild = all rows). Later
                    # acks must agree — replicas are deterministic.
                    affected = result.get("affected_row_list")
                    self._epochs.append(_Epoch(
                        token=token,
                        wire_req=up.wire,
                        affected=(
                            frozenset(affected) if affected is not None
                            else None
                        ),
                        rid=urid,
                    ))
                    up.epoch_index = len(self._epochs) - 1
                    self._epoch_by_token[tuple(token)] = up.epoch_index
                    up.first_result = result
                elif tuple(token) != self._epochs[up.epoch_index].token:
                    runtime_event(
                        "router_token_divergence", worker_id=wid,
                        got=token,
                        expected=self._epochs[up.epoch_index].token,
                    )
            w = self.workers.get(wid)
            if w is not None:
                epoch = self._epoch_of(token)
                w.token = token
                w.epoch = epoch if epoch is not None else -1
                if is_catchup:
                    if 0 <= w.epoch < len(self._epochs) - 1:
                        next_catchup = w.epoch + 1  # keep replaying
                    else:
                        w.catchup_active = False
            if up is not None:
                up.waiting.discard(wid)
                up.acks[wid] = result
                get_tracer().finish(
                    up.target_spans.pop(wid, None), outcome="ack"
                )
                # a replica that missed the broadcast but caught up
                # before the update finished has APPLIED it — it must
                # not be reported as both applied and lagging
                up.failures.pop(wid, None)
                if not up.waiting:
                    finished = self._updates.pop(urid)
            self._compact_epochs()
        if next_catchup is not None:
            self._send_catchup(wid, next_catchup)
        if finished is not None:
            self._finish_update(finished)

    def _update_failure(self, urid: str, wid: str, error: str) -> None:
        finished = None
        with self._lock:
            up = self._updates.get(urid)
            if up is None:
                return
            up.waiting.discard(wid)
            up.failures[wid] = error
            get_tracer().finish(
                up.target_spans.pop(wid, None), outcome="missed",
                error=error,
            )
            if not up.waiting:
                finished = self._updates.pop(urid)
        runtime_event(
            "router_update_miss", worker_id=wid, rid=urid, error=error,
        )
        if finished is not None:
            self._finish_update(finished)

    def _finish_update(self, up: _UpdatePending) -> None:
        ok = up.epoch_index is not None
        tracer = get_tracer()
        for span in up.target_spans.values():
            tracer.finish(span, outcome="timeout")
        up.target_spans.clear()
        tracer.finish(up.span, outcome="ok" if ok else "failed")
        # a replica lags only behind an epoch some replica applied: an
        # update every replica refused (e.g. one that would push a path
        # count past the exactness guard; each replica left itself as
        # it was) moves no epoch, so nothing lags and nothing is fenced
        result = {
            "applied": sorted(up.acks),
            "missed": dict(up.failures),
            "lagging": sorted(up.failures) if ok else [],
        }
        if up.first_result is not None:
            result.update({
                k: up.first_result[k]
                for k in ("mode", "affected_rows", "delta_seq", "base_fp",
                          "fingerprint", "n")
                if k in up.first_result
            })
        runtime_event(
            "router_update", rid=up.rid, applied=len(up.acks),
            missed=len(up.failures), echo=False,
        )
        error = "update applied on no replica"
        reasons = set(up.failures.values())
        if len(reasons) == 1:
            error += f": {reasons.pop()}"
        up.future.set_result({
            "id": up.client_id, "ok": ok,
            **({"result": result} if ok else
               {"error": error, "detail": result}),
        })

    def _sweep_updates(self, now: float) -> None:
        expired: list[_UpdatePending] = []
        with self._lock:
            for urid, up in list(self._updates.items()):
                if now - up.t0 > self.config.update_timeout_s:
                    for wid in list(up.waiting):
                        up.failures[wid] = "ack timeout"
                    up.waiting.clear()
                    expired.append(self._updates.pop(urid))
        for up in expired:
            self._finish_update(up)

    def _send_catchup(self, wid: str, from_epoch: int) -> None:
        """Replay the FIRST missed update to a lagging replica; its ack
        advances the epoch and triggers the next replay (ordered — a
        delta chain applied out of order is a different graph)."""
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status != UP:
                if w is not None:
                    w.catchup_active = False
                return
            if from_epoch >= len(self._epochs) or from_epoch < 1:
                w.catchup_active = False
                return
            epoch = self._epochs[from_epoch]
            if epoch.wire_req is None:
                # nothing replayable (shouldn't happen: every epoch > 0
                # records its wire request) — leave the replica fenced
                w.catchup_active = False
                runtime_event(
                    "router_catchup_impossible", worker_id=wid,
                    epoch=from_epoch,
                )
                return
            wire = dict(epoch.wire_req)
            wire["id"] = f"cu:{wid}:{epoch.rid[1:]}"
        runtime_event(
            "router_catchup", worker_id=wid, epoch=from_epoch,
            rid=epoch.rid, echo=False,
        )
        try:
            w.transport.send(wire)
        except WorkerGone:
            self._mark_down(wid, DOWN, "catchup send failed")

    def _submit_invalidate(self, req: dict, fut: Future) -> Future:
        acked = 0
        with self._lock:
            targets = list(self.workers.values())
        for w in targets:
            if w.status != UP or not w.transport.alive:
                continue
            try:
                w.transport.send({
                    "id": f"inv:{w.wid}", "op": "invalidate",
                })
                acked += 1
            except WorkerGone:
                self._mark_down(w.wid, DOWN, "send failed")
        fut.set_result({
            "id": req.get("id"), "ok": True,
            "result": {"invalidated": True, "workers": acked},
        })
        return fut

    # -- dynamic membership (router/autoscale.py) --------------------------

    def _rebuild_policy(self) -> None:
        """Re-derive the routing policy over the CURRENT live set —
        caller holds the lock. Hash-ring membership changes move some
        rows' affinity (those rows re-warm on their new replica); the
        fencing/failover machinery is membership-agnostic."""
        live = [
            wid for wid, w in self.workers.items()
            if w.status not in (DOWN, DRAINING)
        ]
        if live:
            self.policy = make_policy(
                self.config.routing, live, n_rows=max(self.n, 1),
                vnodes=self.config.vnodes,
            )

    def add_worker(self, wid: str, transport,
                   ready_timeout: float = 180.0) -> dict:
        """Bring one NEW replica into the live fleet (the autoscale
        spawn primitive): start its transport, wait for ready, verify
        it serves a token from our epoch history (a fresh boot is
        epoch 0 — the base graph), register it, and rebuild the
        routing policy. The worker's first pong triggers the ordered
        catch-up replay of every missed epoch (idempotent by request
        id), and it stays fenced from affected rows until caught up —
        spawning can never serve stale data, only warm up."""
        transport.start(self._on_message, self._on_death)
        info = transport.wait_ready(ready_timeout)
        token = (info.get("base_fp"), int(info.get("delta_seq", 0)))
        with self._lock:
            if wid in self.workers:
                raise ValueError(f"worker id {wid!r} already registered")
            epoch = self._epoch_of(token)
            if epoch is None:
                raise ValueError(
                    f"spawned worker {wid} serves token {token} outside "
                    "this router's epoch history — wrong dataset/config"
                )
            w = _WorkerState(wid, transport)
            w.token = token
            w.epoch = epoch
            w.last_pong = time.monotonic()
            self.workers[wid] = w
            self._rebuild_policy()
            lag = len(self._epochs) - 1 - epoch
        runtime_event(
            "router_worker_added", worker_id=wid, epoch=epoch, lag=lag,
        )
        get_registry().counter(
            "dpathsim_autoscale_workers_added_total",
            "workers spawned into the live fleet",
        ).inc()
        return info

    def remove_worker(self, wid: str) -> bool:
        """Begin a graceful drain of one replica (the autoscale drain
        primitive): mark it DRAINING (routed around from this instant,
        never readmitted), rebuild the policy, and request the drain —
        SIGTERM for subprocess transports, the in-band ``drain`` op
        in-proc. In-flight work completes (new queries get retriable
        ``draining`` errors the failover path reroutes); the clean
        exit surfaces as transport death, after which
        :meth:`reap_workers` removes the entry."""
        with self._lock:
            w = self.workers.get(wid)
            if w is None or w.status in (DOWN, DRAINING):
                return False
            w.status = DRAINING
            self._rebuild_policy()
        runtime_event("router_worker_draining", worker_id=wid)
        get_registry().counter(
            "dpathsim_autoscale_workers_drained_total",
            "workers drained out of the live fleet",
        ).inc()
        try:
            w.transport.terminate()
        except Exception:
            pass  # already dead: on_death handles the bookkeeping
        return True

    def reap_workers(self) -> list[str]:
        """Drop DOWN workers whose transports are gone (drained or
        dead) from the table. Autoscale calls this per tick so cycled
        worker ids don't accumulate; chaos benches that never reap
        keep their post-mortem state, unchanged."""
        reaped = []
        with self._lock:
            for wid, w in list(self.workers.items()):
                if w.status == DOWN and not w.transport.alive:
                    del self.workers[wid]
                    reaped.append(wid)
            if reaped:
                self._rebuild_policy()
        for wid in reaped:
            runtime_event("router_worker_reaped", worker_id=wid,
                          echo=False)
        return reaped

    # -- fleet observability plane -----------------------------------------

    def _scrape_workers(self) -> None:
        """Ask every live worker for its registry snapshot (the
        ``metrics`` op); replies land in :meth:`_on_metrics`. Send
        failures are the heartbeat path's business — here they are
        simply skipped (the merge uses whatever snapshots exist)."""
        with self._lock:
            targets = list(self.workers.values())
        for w in targets:
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

    def _on_trace(self, wid: str, obj: dict) -> None:
        if not obj.get("ok"):
            return
        result = obj.get("result") or {}
        if "spans" not in result:
            return
        with self._lock:
            w = self.workers.get(wid)
            if w is None:
                return
            w.trace_part = {**result, "process": f"worker {wid}"}
            w.trace_seq += 1

    def metric_parts(self) -> dict:
        """The merge inputs: the router's own registry plus every
        worker's last scraped snapshot, keyed by identity. A worker
        never scraped (or dead before its first scrape) simply isn't a
        part — the merge is exact over what exists."""
        parts = {"router": get_registry().snapshot()}
        with self._lock:
            for wid, w in self.workers.items():
                if w.last_metrics is not None:
                    parts[wid] = w.last_metrics
        return parts

    def _evaluate_slo(self, now: float) -> None:
        merged, _ = obs_fleet.merge_registry_snapshots(self.metric_parts())
        self.slo.observe(merged, now)

    def _on_slo_alert(self, info: dict) -> None:
        # the router LOG surface: burn-rate alerts
        # as structured events alongside the engine's counters/gauges
        runtime_event(
            "slo_alert", slo=info["slo"], kind=info["kind"],
            objective=info["objective"],
            burn={k: round(v, 3) for k, v in info["burn"].items()},
        )

    def _wait_scraped(self, seq0: dict, attr: str, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                done = all(
                    w.status == DOWN or not w.transport.alive
                    or getattr(w, attr) > seq0.get(wid, 0)
                    for wid, w in self.workers.items()
                )
            if done:
                return
            time.sleep(0.005)

    def fleet_metrics(self, refresh: bool = True,
                      timeout: float = 5.0) -> dict:
        """The ``fleet_metrics`` op payload: merged (bucket-exact)
        registries with per-worker snapshots' provenance, SLO status,
        and the router's own stats block. ``refresh`` forces a fresh
        scrape round and waits for it — a one-shot ``dpathsim
        fleet-stats`` must not read a snapshot that predates the
        question."""
        if refresh:
            with self._lock:
                seq0 = {w.wid: w.metrics_seq
                        for w in self.workers.values()}
            self._scrape_workers()
            self._wait_scraped(seq0, "metrics_seq", timeout)
        parts = self.metric_parts()
        merged, unmergeable = obs_fleet.merge_registry_snapshots(parts)
        now = time.monotonic()
        with self._lock:
            scrape_age = {
                wid: (
                    round(now - w.metrics_mono, 3)
                    if w.last_metrics is not None else None
                )
                for wid, w in self.workers.items()
            }
        return {
            "router": self.stats()["router"],
            "merged": merged,
            "unmergeable": unmergeable,
            "scrape_age_s": scrape_age,
            "workers_scraped": sorted(k for k in parts if k != "router"),
            "slo": self.slo.snapshot(),
            "flight": {
                "kept_total": self.flight.kept_total,
                "dropped": self.flight.dropped,
                "capacity": self.flight.capacity,
            },
        }

    def collect_trace_parts(self, timeout: float = 5.0) -> list[dict]:
        """The stitched-export inputs: this process's span ring plus a
        fresh ``trace``-op scrape of every live worker's. Dead workers
        contribute whatever their last scrape caught (a SIGKILL takes
        its un-scraped spans with it — the router-side attempt spans
        still record that the dispatch happened)."""
        with self._lock:
            seq0 = {w.wid: w.trace_seq for w in self.workers.values()}
            targets = list(self.workers.values())
        limit = self.config.trace_scrape_limit
        for w in targets:
            if w.status == DOWN or not w.transport.alive:
                continue
            try:
                w.transport.send(
                    {"id": f"tr:{w.wid}:{next(self._tr_seq)}",
                     "op": "trace", "limit": limit}
                )
            except WorkerGone:
                continue
        self._wait_scraped(seq0, "trace_seq", timeout)
        parts = [{**get_tracer().export_state(limit=limit),
                  "process": "router"}]
        with self._lock:
            for w in self.workers.values():
                if w.trace_part is not None:
                    parts.append(w.trace_part)
        return parts

    def write_fleet_trace(self, path: str,
                          parts: list[dict] | None = None) -> int:
        """One stitched Perfetto file for the whole fleet; returns the
        span-event count. ``parts`` reuses an already-collected scrape
        (the shutdown path shares one round across both dumps)."""
        if parts is None:
            parts = self.collect_trace_parts()
        n = obs_fleet.write_fleet_trace(path, parts)
        runtime_event("fleet_trace_written", path=path, spans=n)
        return n

    def flight_dump(self, path: str | None = None,
                    parts: list[dict] | None = None) -> dict:
        """The ``flight_dump`` op: records + kept span trees, written
        atomically when ``path`` is given, inline (records only — span
        trees can be arbitrarily large) otherwise."""
        if path is None:
            return self.flight.snapshot()
        if parts is None:
            parts = (
                self.collect_trace_parts()
                if get_tracer().enabled else []
            )
        info = self.flight.dump(path, parts)
        runtime_event("flight_dump", **info)
        return info

    def _shutdown_dumps(self) -> None:
        """Drain-time artifacts (flight recording, stitched trace) —
        once, best-effort: a failing dump must not block the drain.
        ONE span-ring scrape feeds both dumps; each worker's ring is a
        trace-op round trip of up to 20k spans, not something to ask
        for twice at shutdown."""
        if self._shutdown_dumped:
            return
        self._shutdown_dumped = True
        try:
            parts = None
            if (self.flight_out or self.fleet_trace_out) and (
                get_tracer().enabled
            ):
                parts = self.collect_trace_parts()
            if self.flight_out:
                self.flight_dump(self.flight_out, parts=parts or [])
            if self.fleet_trace_out:
                self.write_fleet_trace(
                    self.fleet_trace_out, parts=parts or []
                )
        except Exception as exc:
            runtime_event("fleet_dump_failed", error=repr(exc))

    # -- introspection -----------------------------------------------------

    def worker_health(self, wid: str, timeout: float = 10.0) -> dict:
        """A FRESH health snapshot from one worker: probe, wait for the
        pong (benches read compile counts around a measurement window,
        so a cached pong from before the window is not good enough)."""
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
        with self._uq_cv:
            queued = len(self._uq)
        with self._lock:
            head = len(self._epochs) - 1
            return {
                "router": {
                    "workers": {
                        w.wid: {
                            "status": w.status,
                            "queue_depth": w.queue_depth,
                            "assigned": len(w.assigned),
                            "epoch": w.epoch,
                            "lag": head - w.epoch,
                            "token": list(w.token) if w.token else None,
                            # ANN index epoch from the last pong (None =
                            # exact-only replica): operators see which
                            # replicas hold a fresh candidate index;
                            # queries never NEED one — an ann request on
                            # an index-less replica answers exactly
                            "index": w.last_health.get("index"),
                            # per-mode epoch map: exact / ann /
                            # learned, each with its own epoch — a
                            # learned request re-dispatched onto a
                            # tower-less replica still answers, exactly
                            "modes": w.last_health.get("modes"),
                        }
                        for w in self.workers.values()
                    },
                    "pending": len(self._pending),
                    "updates_pending": len(self._updates),
                    "epochs": head + 1,
                    "routing": self.config.routing,
                    "draining": self._draining,
                    "n": self.n,
                    # firehose pipelining accounting
                    "firehose": {
                        "update_queue": self.config.update_queue,
                        "queued": queued,
                        "coalesced": self.updates_coalesced,
                        "broadcasts": self.update_broadcasts,
                        "backpressure": self.update_backpressure,
                    },
                    "obs": {
                        "slo_alerts": dict(self.slo.alert_counts),
                        "flight_kept": self.flight.kept_total,
                        "flight_dropped": self.flight.dropped,
                        "scrape_interval_s":
                            self.config.scrape_interval_s,
                    },
                },
            }
