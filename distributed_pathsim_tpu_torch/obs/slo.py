"""SLO engine: declarative objectives, multi-window burn-rate alerts.

An SLO here is a *good-fraction* objective over the merged fleet metric
stream (obs/fleet.py): of the events this spec covers, at least
``objective`` must be good. Four kinds map the repo's own signals onto
that shape:

- ``availability`` — a counter family split good/total by labels
  (router requests with ``outcome="ok"`` vs all outcomes);
- ``latency`` — a histogram family + a threshold: good = samples whose
  bucket bound is ≤ the threshold (conservative: a bucket straddling
  the threshold counts bad). Because the fleet merge is bucket-exact,
  this is the same count a single global registry would report;
- ``staleness`` — identical math over the update-visible-by histogram
  (``dpathsim_serve_update_seconds``): the bounded-staleness SLO,
  measured;
- ``gauge_floor`` — a ratio gauge judged against a floor on its WORST
  replica (merged ``min``), folded into the good-fraction stream one
  observation per evaluation (the ann score-recall floor).

Alerting is the multi-window burn-rate scheme (the SRE-workbook one):
``burn = error_rate / error_budget`` computed over each configured
window from cumulative (good, total) deltas; an alert fires only when
EVERY window burns past its threshold — the short window proves it's
happening *now*, the long one proves it isn't a blip — and alerts are
rate-limited per spec. Burn rates surface as
``dpathsim_slo_burn_rate{slo,window}`` gauges and alerts as
``dpathsim_slo_alerts_total{slo}``; the *log* surface is the caller's
(the router passes a ``runtime_event`` callback — obs imports nothing
from the rest of the package, so it cannot emit events itself).
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Callable

from .metrics import get_registry

KINDS = ("availability", "latency", "staleness", "gauge_floor")

# (window_seconds, burn_threshold): the classic fast/slow pairing,
# scaled to this repo's scrape cadence. Tests/smokes override with
# second-scale windows; production overrides via --slo-specs.
DEFAULT_WINDOWS = ((60.0, 14.4), (300.0, 6.0))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective. ``labels`` filters the metric's cells
    (subset match); ``good_labels`` marks the good subset (availability
    kind); ``threshold`` is the latency/staleness bound in seconds, or
    the gauge floor. ``windows`` is ``((seconds, burn_threshold), ...)``
    — every window must burn for an alert."""

    name: str
    kind: str
    metric: str
    objective: float
    threshold: float | None = None
    labels: tuple = ()
    good_labels: tuple = ()
    windows: tuple = DEFAULT_WINDOWS

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown SLO kind {self.kind!r}; choose one of {KINDS}"
            )
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective} — "
                "1.0 leaves a zero error budget and burn is undefined"
            )
        if self.kind in ("latency", "staleness", "gauge_floor") and (
            self.threshold is None
        ):
            raise ValueError(f"SLO kind {self.kind!r} needs a threshold")
        if not self.windows:
            raise ValueError("an SLO needs at least one window")


def default_specs(
    latency_p99_s: float = 0.25,
    staleness_p99_s: float = 5.0,
    availability: float = 0.999,
    recall_floor: float = 0.98,
    cold_start_floor: float = 0.95,
    windows: tuple = DEFAULT_WINDOWS,
) -> tuple[SLOSpec, ...]:
    """The shipped fleet objectives (the JAX package's, so both fleets
    report the same SLO names) — every one reads a metric the serving
    tier emits, so the engine works on day one with no config:
    availability and p99 latency over the router's request stream,
    update-visible-by staleness over the delta path, the ann
    score-recall floor (worst replica), and the learned tier's
    cold-start answerability floor (fraction of appended rows already
    absorbed into the towers, worst replica — a replica falling behind
    on absorbs is answering its cold-start authors through counted
    fallbacks instead of the learned arm; a replica without towers
    reports none)."""
    return (
        SLOSpec(
            name="availability", kind="availability",
            metric="dpathsim_router_requests_total",
            objective=availability, good_labels=(("outcome", "ok"),),
            windows=windows,
        ),
        SLOSpec(
            name="latency_p99", kind="latency",
            metric="dpathsim_router_request_seconds",
            objective=0.99, threshold=latency_p99_s, windows=windows,
        ),
        SLOSpec(
            name="update_visible", kind="staleness",
            metric="dpathsim_serve_update_seconds",
            objective=0.99, threshold=staleness_p99_s, windows=windows,
        ),
        SLOSpec(
            name="ann_recall", kind="gauge_floor",
            metric="dpathsim_ann_recall_ratio",
            objective=0.99, threshold=recall_floor, windows=windows,
        ),
        SLOSpec(
            name="cold_start_answerable", kind="gauge_floor",
            metric="dpathsim_learned_cold_start_ratio",
            objective=0.99, threshold=cold_start_floor,
            windows=windows,
        ),
    )


def specs_from_json(text: str) -> tuple[SLOSpec, ...]:
    """Parse a JSON list of spec dicts (the ``--slo-specs`` file).
    Label maps become the tuple form; unknown keys are rejected loudly
    (a typoed field silently ignored would be an SLO that never
    fires)."""
    raw = json.loads(text)
    if not isinstance(raw, list):
        raise ValueError("SLO spec file must be a JSON list of objects")
    specs = []
    fields = {f.name for f in dataclasses.fields(SLOSpec)}
    for entry in raw:
        unknown = set(entry) - fields
        if unknown:
            raise ValueError(
                f"unknown SLO spec fields {sorted(unknown)} in "
                f"{entry.get('name', '?')!r}"
            )
        for key in ("labels", "good_labels"):
            if isinstance(entry.get(key), dict):
                entry[key] = tuple(sorted(entry[key].items()))
        if "windows" in entry:
            entry["windows"] = tuple(
                (float(w), float(b)) for w, b in entry["windows"]
            )
        specs.append(SLOSpec(**entry))
    return tuple(specs)


def _matches(cell_labels: dict, want: tuple) -> bool:
    return all(cell_labels.get(k) == str(v) for k, v in want)


def good_total_from_snapshot(
    spec: SLOSpec, merged: dict
) -> tuple[float, float]:
    """Extract this spec's CUMULATIVE (good, total) from a merged fleet
    snapshot. For ``gauge_floor`` the return is the instantaneous
    verdict ``(1|0, 1)`` — the engine accumulates it."""
    fam = merged.get(spec.metric)
    if not fam:
        return 0.0, 0.0
    cells = [
        c for c in fam["values"] if _matches(c["labels"], spec.labels)
    ]
    if spec.kind == "availability":
        total = sum(c["value"] for c in cells)
        good = sum(
            c["value"] for c in cells
            if _matches(c["labels"], spec.good_labels)
        )
        return good, total
    if spec.kind in ("latency", "staleness"):
        bounds = fam.get("bounds") or []
        good = total = 0.0
        for c in cells:
            total += c["count"]
            good += c["underflow"]
            for bound, n in zip(bounds, c["_counts"]):
                if bound <= spec.threshold:
                    good += n
        return good, total
    # gauge_floor: the worst replica must clear the floor
    if not cells:
        return 0.0, 0.0
    worst = min(c.get("min", c["value"]) for c in cells)
    return (1.0 if worst >= spec.threshold else 0.0), 1.0


class SLOEngine:
    """Evaluates specs over a stream of merged snapshots.

    ``observe(merged, now)`` is called by the router after each scrape
    merge; it appends each spec's cumulative (good, total) to a
    monotonic-time ring, computes every window's burn rate from the
    deltas, publishes the gauges, and fires rate-limited alerts through
    ``on_alert`` when all windows burn. Windowed deltas over
    *cumulative* counters make the math insensitive to scrape jitter
    and to how many evaluations land inside a window."""

    def __init__(
        self,
        specs: tuple[SLOSpec, ...],
        on_alert: Callable[[dict], None] | None = None,
        min_alert_gap_s: float = 30.0,
    ):
        self.specs = tuple(specs)
        self.on_alert = on_alert
        self.min_alert_gap_s = float(min_alert_gap_s)
        max_w = max(
            (w for spec in self.specs for w, _ in spec.windows),
            default=0.0,
        )
        self._horizon = max_w * 1.5 + 1.0
        self._series: dict[str, deque] = {
            s.name: deque() for s in self.specs
        }
        self._cum_gauge: dict[str, tuple[float, float]] = {}
        self._last_alert: dict[str, float] = {}
        self._burn: dict[str, dict[str, float]] = {
            s.name: {} for s in self.specs
        }
        self.alert_counts: dict[str, int] = {s.name: 0 for s in self.specs}
        reg = get_registry()
        self._g_burn = reg.gauge(
            "dpathsim_slo_burn_rate",
            "error-budget burn rate per SLO and window (1.0 = burning "
            "exactly the budget)",
        )
        self._c_alerts = reg.counter(
            "dpathsim_slo_alerts_total",
            "multi-window burn-rate alerts fired, by SLO",
        )

    def observe(self, merged: dict, now: float) -> list[dict]:
        """Fold one merged snapshot in; returns the alerts fired (also
        delivered via ``on_alert``). ``now`` is monotonic seconds —
        burn windows are durations, never wall clock."""
        alerts: list[dict] = []
        for spec in self.specs:
            good, total = good_total_from_snapshot(spec, merged)
            if spec.kind == "gauge_floor":
                pg, pt = self._cum_gauge.get(spec.name, (0.0, 0.0))
                good, total = pg + good, pt + total
                self._cum_gauge[spec.name] = (good, total)
            series = self._series[spec.name]
            series.append((now, good, total))
            while series and series[0][0] < now - self._horizon:
                series.popleft()
            burns: dict[str, float] = {}
            burning = True
            budget = 1.0 - spec.objective
            for window_s, threshold in spec.windows:
                base = series[0]
                for sample in series:
                    if sample[0] >= now - window_s:
                        base = sample
                        break
                dg = good - base[1]
                dt = total - base[2]
                if dt <= 0:
                    burn = 0.0
                else:
                    burn = max(0.0, 1.0 - dg / dt) / budget
                key = f"{window_s:g}s"
                burns[key] = burn
                self._g_burn.set(burn, slo=spec.name, window=key)
                if burn < threshold or dt <= 0:
                    burning = False
            self._burn[spec.name] = burns
            if burning:
                last = self._last_alert.get(spec.name)
                if last is None or now - last >= self.min_alert_gap_s:
                    self._last_alert[spec.name] = now
                    self.alert_counts[spec.name] += 1
                    self._c_alerts.inc(slo=spec.name)
                    info = {
                        "slo": spec.name,
                        "kind": spec.kind,
                        "objective": spec.objective,
                        "burn": dict(burns),
                        "good": good,
                        "total": total,
                    }
                    alerts.append(info)
                    if self.on_alert is not None:
                        self.on_alert(info)
        return alerts

    def snapshot(self) -> dict:
        """Per-SLO status for ``fleet_metrics`` / ``fleet-stats``."""
        out = {}
        for spec in self.specs:
            series = self._series[spec.name]
            good, total = (series[-1][1], series[-1][2]) if series else (0, 0)
            burns = self._burn[spec.name]
            out[spec.name] = {
                "kind": spec.kind,
                "metric": spec.metric,
                "objective": spec.objective,
                "threshold": spec.threshold,
                "good": good,
                "total": total,
                "burn": dict(burns),
                "alerts": self.alert_counts[spec.name],
                "status": (
                    "burning"
                    if burns and all(
                        burns.get(f"{w:g}s", 0.0) >= t
                        for w, t in spec.windows
                    ) and total > 0
                    else "ok"
                ),
            }
        return out
