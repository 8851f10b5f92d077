"""Fleet-level observability: exact registry merge + stitched traces.

Every process keeps its own truth (registry + span ring); a router over
N workers makes the system a fleet of processes — so "what is the p99"
becomes N disagreeing per-worker answers. This module is the
single-truth layer the router builds on:

- **Exact histogram merge**: every histogram in this repo uses one
  bucket geometry per family, carried in the snapshot (``bounds``).
  Same edges ⇒ merging is bucket-wise integer addition — *exact*, not
  an approximation: the merged cell is bit-identical (counts, min/max,
  every bucket) to a single registry that observed the union of the
  samples, and therefore so is every quantile computed from it (the
  shared :func:`~.metrics.quantile_from_counts`). The merge is
  associative and commutative (integer sums are), so scrape order,
  partial scrapes, and re-merges can never change the answer —
  held to the JAX package's merge in the port's tests. Cells with mismatched
  geometry are refused loudly (``unmergeable``), never silently summed.
- **Per-worker labels preserved**: the fleet Prometheus export renders
  every worker's series with a ``worker`` label added — PromQL's
  ``sum by (le)`` over them is exact for the same reason the local
  merge is. The merged aggregate feeds the SLO engine and
  ``dpathsim-torch fleet-stats``.
- **Stitched traces**: each process exports its span ring with its pid
  and wall anchor (:meth:`~.trace.Tracer.export_state`);
  :func:`fleet_chrome_trace` lays them onto one Perfetto timeline
  (anchored epoch µs align across processes on one host), and
  :func:`audit_fleet_traces` walks every parent link across process
  boundaries — the "zero broken parent links" gate of
  the fleet-observability smoke.

Layering: like the rest of ``obs/``, this module imports nothing from
outside the package — the router calls in, never the reverse.
"""

from __future__ import annotations

import json
import math

from .export import (
    IntervalFileExporter,
    _fmt_labels,
    _fmt_value,
    atomic_write,
)
from .metrics import quantile_from_counts


class MergeError(ValueError):
    """Cells cannot be merged exactly (mismatched type or geometry)."""


def merge_histogram_cells(cells: list[dict], bounds: list[float]) -> dict:
    """Exact merge of histogram cell snapshots sharing ``bounds``:
    bucket-wise sum (integers — associative, commutative, exact),
    summed count/underflow/overflow, min of mins / max of maxes.
    Quantiles recomputed from the merged buckets with the same
    estimator a live cell uses."""
    n = len(bounds)
    counts = [0] * n
    underflow = overflow = count = 0
    total = 0.0
    vmin, vmax = math.inf, -math.inf
    for c in cells:
        cc = c["_counts"]
        if len(cc) != n:
            raise MergeError(
                f"histogram geometry mismatch: {len(cc)} buckets vs "
                f"{n} — cells must share edges to merge exactly"
            )
        for i, v in enumerate(cc):
            counts[i] += v
        underflow += c["underflow"]
        overflow += c["overflow"]
        count += c["count"]
        total += c["sum"]
        if c["count"]:
            vmin = min(vmin, c["min"])
            vmax = max(vmax, c["max"])
    merged = {
        "count": count,
        "sum": total,
        "min": None if count == 0 else vmin,
        "max": None if count == 0 else vmax,
        "underflow": underflow,
        "overflow": overflow,
    }
    for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        v = quantile_from_counts(
            tuple(bounds), counts, underflow, count, vmin, vmax, q
        )
        merged[key] = None if math.isnan(v) else v
    merged["_counts"] = counts
    return merged


def _merge_scalar_cells(cells: list[dict]) -> dict:
    """Counters/gauges merge by sum, with the per-worker min/max kept
    alongside: a fleet queue depth or request total is the sum, but a
    floor-style SLO over a ratio gauge (ann recall) must judge the
    WORST replica, which the sum would hide."""
    vals = [float(c["value"]) for c in cells]
    return {
        "value": sum(vals),
        "min": min(vals),
        "max": max(vals),
        "cells": len(vals),
    }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def merge_registry_snapshots(
    parts: dict[str, dict],
) -> tuple[dict, list[str]]:
    """Merge per-process registry snapshots (``worker_id → snapshot``)
    into one fleet snapshot with the same family shape. Cells are
    grouped by their label set across workers and merged exactly;
    families whose cells cannot merge (bucket-geometry disagreement —
    a replica on different code) land in the returned ``unmergeable``
    list instead of poisoning the rest."""
    merged: dict = {}
    unmergeable: list[str] = []
    names: dict[str, None] = {}
    for snap in parts.values():
        for name in snap:
            names.setdefault(name)
    for name in names:
        fams = [
            (wid, snap[name]) for wid, snap in parts.items()
            if name in snap
        ]
        kinds = {f["type"] for _, f in fams}
        if len(kinds) != 1:
            unmergeable.append(name)
            continue
        kind = next(iter(kinds))
        bounds = None
        if kind == "histogram":
            all_bounds = {tuple(f.get("bounds") or ()) for _, f in fams}
            if len(all_bounds) != 1 or () in all_bounds:
                unmergeable.append(name)
                continue
            bounds = list(next(iter(all_bounds)))
        by_labels: dict[tuple, list[dict]] = {}
        label_of: dict[tuple, dict] = {}
        for _, fam in fams:
            for cell in fam["values"]:
                key = _label_key(cell["labels"])
                by_labels.setdefault(key, []).append(cell)
                label_of.setdefault(key, dict(cell["labels"]))
        try:
            values = []
            for key in sorted(by_labels):
                cells = by_labels[key]
                if kind == "histogram":
                    out = merge_histogram_cells(cells, bounds)
                else:
                    out = _merge_scalar_cells(cells)
                values.append({"labels": label_of[key], **out})
        except MergeError:
            unmergeable.append(name)
            continue
        merged[name] = {
            "type": kind,
            "help": fams[0][1].get("help", ""),
            "values": values,
        }
        if bounds is not None:
            merged[name]["bounds"] = bounds
    return merged, unmergeable


# -- Prometheus rendering from snapshots -------------------------------------


def render_fleet_prometheus(parts: dict[str, dict]) -> str:
    """Prometheus text 0.0.4 over per-process snapshots, every series
    carrying a ``worker`` label — per-worker resolution preserved, and
    (same edges everywhere) ``sum by (le)`` aggregation in PromQL is
    exactly the bucket-wise merge :func:`merge_registry_snapshots`
    performs locally."""
    names: dict[str, tuple[str, str]] = {}
    for snap in parts.values():
        for name, fam in snap.items():
            names.setdefault(name, (fam["type"], fam.get("help", "")))
    lines: list[str] = []
    for name in sorted(names):
        kind, help_ = names[name]
        lines.append(f"# HELP {name} {help_ or name}")
        lines.append(f"# TYPE {name} {kind}")
        for wid in sorted(parts):
            fam = parts[wid].get(name)
            if fam is None or fam["type"] != kind:
                continue
            bounds = fam.get("bounds") or []
            for cell in fam["values"]:
                labels = {**cell["labels"], "worker": wid}
                if kind == "histogram":
                    cum = cell["underflow"]
                    for bound, c in zip(bounds, cell["_counts"]):
                        cum += c
                        le = 'le="{}"'.format(_fmt_value(bound))
                        lines.append(
                            f"{name}_bucket{_fmt_labels(labels, le)} {cum}"
                        )
                    le_inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_fmt_labels(labels, le_inf)}"
                        f" {cell['count']}"
                    )
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)}"
                        f" {_fmt_value(cell['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_fmt_labels(labels)} {cell['count']}"
                    )
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)}"
                        f" {_fmt_value(cell['value'])}"
                    )
    return "\n".join(lines) + "\n"


def write_fleet_textfile(path: str, parts: dict[str, dict]) -> None:
    """One atomic fleet scrape (same contract as
    :func:`~.export.write_textfile`)."""
    atomic_write(path, render_fleet_prometheus(parts))


class FleetTextfileExporter(IntervalFileExporter):
    """The router's interval exporter: re-renders the fleet Prometheus
    textfile from the latest scraped snapshots, plus (optionally) the
    full ``fleet_metrics`` JSON beside it (``<path>.json``) — the file
    ``dpathsim-torch fleet-stats`` reads. Lifecycle (immediate first write,
    interval thread, final write on stop) from
    :class:`~.export.IntervalFileExporter`."""

    thread_name = "pathsim-fleet-export"

    def __init__(
        self,
        path: str,
        parts_fn,
        interval_s: float = 5.0,
        snapshot_fn=None,
    ):
        super().__init__(interval_s)
        self.path = path
        self.parts_fn = parts_fn
        self.snapshot_fn = snapshot_fn

    def write(self) -> None:
        write_fleet_textfile(self.path, self.parts_fn())
        if self.snapshot_fn is not None:
            atomic_write(
                f"{self.path}.json", json.dumps(self.snapshot_fn())
            )


# -- stitched traces ---------------------------------------------------------


def fleet_chrome_trace(trace_parts: list[dict]) -> dict:
    """Per-process tracer exports (:meth:`Tracer.export_state`) merged
    onto ONE Chrome/Perfetto timeline: each part keeps its pid lane,
    monotonic timestamps map through each process's own wall anchor
    (same host ⇒ one epoch axis), and span identity rides in ``args``
    exactly as the single-process export does — so a router-rooted
    request renders as one tree crossing process lanes."""
    events: list[dict] = []
    for part in trace_parts:
        pid = int(part.get("pid", 0))
        anchor = float(part.get("wall_anchor_us", 0.0))
        seen_tids: dict[int, str] = {}
        for s in part.get("spans", ()):
            end_ns = (
                s["t_end_ns"] if s.get("t_end_ns") is not None
                else s["t_start_ns"]
            )
            tid = int(s.get("tid", 0))
            events.append(
                {
                    "name": s["name"],
                    "cat": "pathsim",
                    "ph": "X",
                    "pid": pid,
                    "tid": tid,
                    "ts": anchor + s["t_start_ns"] / 1e3,
                    "dur": (end_ns - s["t_start_ns"]) / 1e3,
                    "args": {
                        "trace_id": s["trace_id"],
                        "span_id": s["span_id"],
                        "parent_id": s["parent_id"],
                        **s.get("args", {}),
                    },
                }
            )
            seen_tids.setdefault(tid, s.get("thread", ""))
        for tid, tname in seen_tids.items():
            events.append(
                {
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname},
                }
            )
        events.append(
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": part.get("process", f"pid {pid}")},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_fleet_trace(path: str, trace_parts: list[dict]) -> int:
    """Dump the merged fleet timeline atomically; returns the span
    event count."""
    doc = fleet_chrome_trace(trace_parts)
    atomic_write(path, json.dumps(doc))
    return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


def audit_fleet_traces(trace_parts: list[dict]) -> dict:
    """Walk every parent link across the merged exports — the
    correctness gate for cross-process stitching. A *broken* link is a
    span whose ``parent_id`` resolves to no exported span (or to a span
    of a different trace); a trace is *stitched* when its spans come
    from ≥2 pids and every link in it resolves. Spans lost with a
    SIGKILLed worker simply aren't exported — absence of a subtree is
    not a broken link, a dangling parent reference is."""
    by_id: dict[int, dict] = {}
    by_trace: dict[int, list[tuple[int, dict]]] = {}
    for part in trace_parts:
        pid = int(part.get("pid", 0))
        for s in part.get("spans", ()):
            by_id[s["span_id"]] = s
            by_trace.setdefault(s["trace_id"], []).append((pid, s))
    traces = cross = stitched = broken_total = 0
    for tid, members in by_trace.items():
        traces += 1
        pids = {pid for pid, _ in members}
        broken = 0
        for _, s in members:
            parent = s.get("parent_id")
            if parent is None:
                continue
            ps = by_id.get(parent)
            if ps is None or ps["trace_id"] != tid:
                broken += 1
        broken_total += broken
        if len(pids) >= 2:
            cross += 1
            if broken == 0:
                stitched += 1
    return {
        "traces": traces,
        "cross_process_traces": cross,
        "stitched_cross_process": stitched,
        "broken_parent_links": broken_total,
        "total_spans": len(by_id),
        "processes": len(trace_parts),
    }


# -- the `dpathsim-torch fleet-stats` renderer -------------------------------


def _cells(merged: dict, metric: str) -> list[dict]:
    fam = merged.get(metric)
    return fam["values"] if fam else []


def _sum_matching(merged: dict, metric: str, **labels) -> float:
    total = 0.0
    for cell in _cells(merged, metric):
        if all(cell["labels"].get(k) == v for k, v in labels.items()):
            total += cell.get("value", cell.get("count", 0.0))
    return total


def render_fleet_stats(data: dict) -> str:
    """The ``dpathsim-torch fleet-stats`` one-shot summary: worker table,
    fleet-exact merged latency per op, headline counters, SLO status.
    ``data`` is a ``fleet_metrics`` result (or the JSON the router's
    ``--metrics-file`` exporter writes beside the .prom)."""
    lines: list[str] = []
    router = data.get("router") or {}
    workers = router.get("workers") or {}
    up = sum(1 for w in workers.values() if w.get("status") == "up")
    lines.append(
        f"fleet: {len(workers)} workers ({up} up)"
        f"  routing={router.get('routing', '?')}"
        f"  epochs={router.get('epochs', '?')}"
        f"  pending={router.get('pending', '?')}"
        + ("  DRAINING" if router.get("draining") else "")
    )
    if workers:
        lines.append("")
        lines.append(
            f"{'worker':<8}{'status':<9}{'queue':>6}{'lag':>5}"
            f"{'assigned':>9}  index"
        )
        for wid in sorted(workers):
            w = workers[wid]
            idx = w.get("index")
            idx_s = (
                f"epoch={idx.get('epoch')}" if isinstance(idx, dict)
                else "-"
            )
            lines.append(
                f"{wid:<8}{w.get('status', '?'):<9}"
                f"{w.get('queue_depth', 0):>6}{w.get('lag', 0):>5}"
                f"{w.get('assigned', 0):>9}  {idx_s}"
            )
    merged = data.get("merged") or {}
    # three latency views, all merged fleet-exact: the router's
    # submit-to-resolve (what clients feel), the workers' serve path
    # by outcome (where topk actually runs — the async worker loop
    # doesn't route topk through the per-op protocol histogram), and
    # the per-protocol-op view (updates, scrapes, health)
    for title, metric, axis in (
        ("router latency (submit→resolve)",
         "dpathsim_router_request_seconds", "outcome"),
        ("serve latency (worker topk path)",
         "dpathsim_serve_request_seconds", "outcome"),
        ("protocol op latency", "dpathsim_request_seconds", "op"),
    ):
        cells = [c for c in _cells(merged, metric) if c["count"]]
        if not cells:
            continue
        lines.append("")
        lines.append(f"{title} — merged fleet-exact histograms:")
        lines.append(
            f"{axis:<16}{'count':>9}{'p50ms':>10}{'p95ms':>10}"
            f"{'p99ms':>10}"
        )
        for cell in cells:
            name = cell["labels"].get(axis, "?")
            lines.append(
                f"{name:<16}{cell['count']:>9}"
                f"{(cell['p50'] or 0) * 1e3:>10.3f}"
                f"{(cell['p95'] or 0) * 1e3:>10.3f}"
                f"{(cell['p99'] or 0) * 1e3:>10.3f}"
            )
    counters = []
    for label, metric, kw in (
        ("ok", "dpathsim_router_requests_total", {"outcome": "ok"}),
        ("error", "dpathsim_router_requests_total", {"outcome": "error"}),
        ("shed", "dpathsim_router_requests_total", {"outcome": "shed"}),
        ("failovers", "dpathsim_router_failovers_total", {}),
        ("hedges", "dpathsim_router_hedges_total", {}),
        ("dup_responses", "dpathsim_router_dup_responses_total", {}),
        ("ann_fallbacks", "dpathsim_ann_fallbacks_total", {}),
    ):
        v = _sum_matching(merged, metric, **kw)
        if v:
            counters.append(f"{label}={int(v)}")
    if counters:
        lines.append("")
        lines.append("counters: " + "  ".join(counters))
    slo = data.get("slo") or {}
    if slo:
        lines.append("")
        lines.append("slo:")
        lines.append(
            f"{'name':<18}{'objective':>10}{'status':>9}"
            f"{'alerts':>8}  burn rates"
        )
        for name in sorted(slo):
            s = slo[name]
            burns = "  ".join(
                f"{w}={b:.2f}" for w, b in sorted(
                    (s.get("burn") or {}).items()
                )
            )
            lines.append(
                f"{name:<18}{s.get('objective', 0) * 100:>9.2f}%"
                f"{s.get('status', '?'):>9}{s.get('alerts', 0):>8}  {burns}"
            )
    return "\n".join(lines)
