"""Tail-sampled flight recorder: keep the requests worth explaining.

Head sampling (obs/trace.py) decides *before* a request runs whether to
trace it — cheap, but blind: the request you need to explain (the p99
straggler, the one that failed over through a dead worker) is exactly
the one a 1-in-N coin flip probably dropped. Tail sampling decides
*after* the outcome is known. This recorder is the fleet's tail: the
router classifies every resolved request (slow past the p99 target,
errored, shed, hedged, failed over, degraded from ann) and admits the
interesting ones into a bounded ring — 100% of them, independent of
the head-sampling rate, which keeps doing its job for the *ordinary*
traffic.

What a record holds: the request's identity (rid, op, row), outcome,
per-attempt worker history, timing, reasons — and its ``trace_id``.
When tracing is on and the request's head was sampled in, the full
cross-process span tree is recoverable: :meth:`dump` filters the
per-process tracer exports the caller provides down to the kept trace
ids and writes records + span trees as one atomic JSON (the ``spans``
section is directly loadable by :func:`obs.fleet.fleet_chrome_trace`).
A head-sampled-out request still keeps its record — metadata is never
dropped; only the span tree needs the head's cooperation.

Memory discipline matches the tracer ring: a bounded deque, oldest
evicted, eviction counted (``dpathsim_flight_dropped_total``) so a
ring too small for the failure rate is visible instead of silent.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from .metrics import get_registry

# the classification vocabulary — the router's reasons and the tests'
# assertions share one spelling
REASONS = (
    "slow", "error", "shed", "hedged", "failover", "ann_fallback",
)


class FlightRecorder:
    """Bounded keep-ring of interesting-request records."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self.kept_total = 0
        self.dropped = 0
        reg = get_registry()
        self._m_kept = reg.counter(
            "dpathsim_flight_kept_total",
            "requests admitted to the flight recorder, by reason "
            "(a request with several reasons counts once per reason)",
        )
        self._m_dropped = reg.counter(
            "dpathsim_flight_dropped_total",
            "flight records evicted by the ring bound",
        ).labels()

    def keep(
        self,
        reasons: list[str] | tuple[str, ...],
        trace_id: int | None = None,
        **meta,
    ) -> None:
        """Admit one record. ``reasons`` is the non-empty classification
        (see :data:`REASONS`); ``meta`` is JSON-safe request detail."""
        record = {
            "reasons": list(reasons),
            "trace_id": trace_id,
            "t_mono": time.monotonic(),
            **meta,
        }
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
                self._m_dropped.inc()
            self._ring.append(record)
            self.kept_total += 1
        for reason in reasons:
            self._m_kept.inc(reason=reason)

    def records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def kept_trace_ids(self) -> set[int]:
        with self._lock:
            return {
                r["trace_id"] for r in self._ring
                if r.get("trace_id") is not None
            }

    def snapshot(self) -> dict:
        with self._lock:
            records = [dict(r) for r in self._ring]
            return {
                "capacity": self.capacity,
                "kept_total": self.kept_total,
                "dropped": self.dropped,
                "records": records,
            }

    def dump(
        self,
        path: str,
        trace_parts: list[dict] | None = None,
    ) -> dict:
        """Write records + the kept requests' span trees atomically
        (temp file + rename — a dump raced by SIGTERM must never leave
        half a file). ``trace_parts`` are per-process tracer exports
        (router + scraped workers); only spans belonging to kept trace
        ids are retained, each part keeping its pid/wall-anchor so the
        dump's ``spans`` section feeds ``fleet_chrome_trace`` directly.
        Returns the accounting the ``flight_dump`` op answers with."""
        snap = self.snapshot()
        kept = {
            r["trace_id"] for r in snap["records"]
            if r.get("trace_id") is not None
        }
        parts_out = []
        n_spans = 0
        for part in trace_parts or ():
            spans = [
                s for s in part.get("spans", ())
                if s["trace_id"] in kept
            ]
            n_spans += len(spans)
            parts_out.append({
                "pid": part.get("pid"),
                "process": part.get("process"),
                "wall_anchor_us": part.get("wall_anchor_us"),
                "spans": spans,
            })
        from .export import atomic_write

        doc = {**snap, "spans": parts_out}
        atomic_write(path, json.dumps(doc))
        return {
            "path": path,
            "records": len(snap["records"]),
            "kept_total": snap["kept_total"],
            "dropped": snap["dropped"],
            "spans": n_spans,
        }
