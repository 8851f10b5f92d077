"""Process-wide metrics registry: counters, gauges, streaming histograms.

Without it, "what is the cache hit rate right now" would mean
replaying the ``runtime_event`` JSONL lines. The registry holds live
aggregates instead:

- **Counter** — monotone totals (cache hits, sheds, retries, compiles);
- **Gauge** — last-write-wins instantaneous values (queue depth);
- **Histogram** — bounded-memory streaming latency distributions:
  geometric buckets (``buckets_per_decade`` per power of ten) between
  ``lo`` and ``hi``, plus underflow/overflow, plus exact min/max/sum.
  p50/p95/p99 come from cumulative bucket counts with log-linear
  interpolation inside the landing bucket, clamped to the observed
  min/max — no samples are ever stored, so memory is O(buckets) no
  matter how many observations land (~1 KB per label set at the
  default resolution). Relative quantile error is bounded by the
  bucket width ratio (10^(1/16) ≈ 15% worst case at the default 16
  buckets/decade), verified against ``numpy.percentile`` on
  adversarial distributions by test.

Label support is Prometheus-shaped: a metric family (name + help) fans
out into cells keyed by sorted ``(label, value)`` tuples. Hot paths
bind a cell ONCE (``counter.labels(tier="result")``) and pay one lock +
one add per event thereafter — no registry lookup, no string formatting.

The whole subsystem honors one global switch (``enabled``): disabled,
every ``inc``/``set``/``observe`` is a single attribute check and a
return, so a run that never asks for metrics cannot measure their cost.

Thread safety: creation (get-or-create of families/cells) takes the
registry lock; per-cell mutation takes the cell's own lock — client
threads and the coalescer's dispatcher/completer pair touch these
concurrently.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Iterator

# -- histogram bucket geometry ----------------------------------------------

DEFAULT_LO = 1e-6  # 1 µs — below any latency this system can resolve
DEFAULT_HI = 100.0  # 100 s — beyond any single request we'd serve
DEFAULT_BUCKETS_PER_DECADE = 16


def geometric_bounds(
    lo: float = DEFAULT_LO,
    hi: float = DEFAULT_HI,
    buckets_per_decade: int = DEFAULT_BUCKETS_PER_DECADE,
) -> tuple[float, ...]:
    """Upper bucket bounds, geometric between ``lo`` and ``hi``
    inclusive. Bound i covers (bound[i-1], bound[i]]."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    n = int(math.ceil(math.log10(hi / lo) * buckets_per_decade))
    ratio = 10.0 ** (1.0 / buckets_per_decade)
    bounds = [lo * ratio**i for i in range(n + 1)]
    bounds[-1] = max(bounds[-1], hi)
    return tuple(bounds)


def quantile_from_counts(
    bounds: tuple[float, ...],
    counts: list[int],
    underflow: int,
    count: int,
    vmin: float,
    vmax: float,
    q: float,
) -> float:
    """The quantile estimator as a pure function of bucket state —
    the ONE implementation, shared by live cells and by any merge of
    snapshots, so a quantile computed from exactly-merged buckets is
    the same number each process would have reported for the same
    samples. Log-linear interpolation inside the
    landing bucket, clamped to the observed min/max; tail-INCLUSIVE
    nearest-rank convention (target = q·count) — see
    ``_HistogramCell.quantile`` for why the strict walk under-reports
    discrete tails."""
    if count == 0:
        return math.nan
    target = q * count
    cum = float(underflow)
    if target <= cum:
        # inside the underflow bucket: all we know is [min, lo]
        return vmin
    prev_bound = bounds[0]
    for i, c in enumerate(counts):
        if c:
            if target <= cum + c:
                frac = (target - cum) / c
                blo = max(prev_bound, vmin)
                bhi = min(bounds[i], vmax)
                if blo >= bhi:
                    return bhi
                # log-linear: geometric buckets make log-space
                # interpolation the unbiased choice
                return math.exp(
                    math.log(blo) + frac * (math.log(bhi) - math.log(blo))
                )
            cum += c
        prev_bound = bounds[i]
    return vmax  # overflow bucket


class _HistogramCell:
    """One label set's streaming distribution. Bounded memory: bucket
    counts + scalar aggregates, never samples."""

    __slots__ = (
        "_lock", "bounds", "counts", "underflow", "overflow",
        "count", "sum", "min", "max", "_reg",
    )

    def __init__(self, bounds: tuple[float, ...], reg: "MetricsRegistry"):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.underflow = 0
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reg = reg

    def observe(self, value: float) -> None:
        if not self._reg.enabled:
            return
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if v <= self.bounds[0]:
                self.underflow += 1
            elif v > self.bounds[-1]:
                self.overflow += 1
            else:
                self.counts[self._bucket_index(v)] += 1

    def _bucket_index(self, v: float) -> int:
        # binary search over the geometric bounds: first bound >= v
        lo, hi = 0, len(self.bounds) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]). Log-linear
        interpolation inside the landing bucket, clamped to the exact
        observed min/max (which also makes <lo and >hi values exact at
        the distribution's edges).

        The rank convention is deliberately tail-INCLUSIVE (nearest
        rank, target = q·count): a q·(count−1) walk with a strict
        comparison lands one sample short of the slow mass when the
        tail is a few discrete samples — nine 1 ms requests plus one
        1 s request would report p99 ≈ 1 ms, a 1000× under-report of
        exactly the signal a latency quantile exists to surface."""
        with self._lock:
            return quantile_from_counts(
                self.bounds, self.counts, self.underflow, self.count,
                self.min, self.max, q,
            )

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self.counts)
            base = {
                "count": self.count,
                "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                "underflow": self.underflow,
                "overflow": self.overflow,
            }
        for key, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            v = self.quantile(q)
            # None, not NaN: snapshots feed json.dumps, and the bare
            # NaN token Python emits is invalid JSON to strict parsers
            base[key] = None if math.isnan(v) else v
        base["_counts"] = counts
        return base

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * len(self.bounds)
            self.underflow = self.overflow = 0
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf


class _ScalarCell:
    """One label set's scalar (counter or gauge)."""

    __slots__ = ("_lock", "value", "_reg")

    def __init__(self, reg: "MetricsRegistry"):
        self._lock = threading.Lock()
        self.value = 0.0
        self._reg = reg

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self.value = float(v)

    def get(self) -> float:
        with self._lock:
            return self.value

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


def _label_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _MetricFamily:
    """Shared machinery: name + help + {label tuple → cell}."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self.registry = registry
        self._cells: dict[tuple, Any] = {}
        self._lock = threading.Lock()

    def _make_cell(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **labels: Any):
        """Get-or-create the cell for one label set. Hot paths call
        this once at setup and keep the cell."""
        key = _label_key(labels)
        cell = self._cells.get(key)
        if cell is None:
            with self._lock:
                cell = self._cells.get(key)
                if cell is None:
                    cell = self._cells[key] = self._make_cell()
        return cell

    def cells(self) -> Iterator[tuple[tuple, Any]]:
        with self._lock:
            return iter(list(self._cells.items()))

    def reset(self) -> None:
        for _, cell in self.cells():
            cell.reset()


class Counter(_MetricFamily):
    """Monotone total. ``inc()`` on the bare family hits the unlabeled
    cell; ``labels(...)`` binds a labeled cell for hot paths."""

    kind = "counter"

    def _make_cell(self) -> _ScalarCell:
        return _ScalarCell(self.registry)

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).inc(n)


class Gauge(_MetricFamily):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def _make_cell(self) -> _ScalarCell:
        return _ScalarCell(self.registry)

    def set(self, v: float, **labels: Any) -> None:
        self.labels(**labels).set(v)

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        self.labels(**labels).inc(n)


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        registry: "MetricsRegistry",
        bounds: tuple[float, ...] | None = None,
    ):
        super().__init__(name, help, registry)
        self.bounds = bounds or geometric_bounds()

    def _make_cell(self) -> _HistogramCell:
        return _HistogramCell(self.bounds, self.registry)

    def observe(self, value: float, **labels: Any) -> None:
        self.labels(**labels).observe(value)


class MetricsRegistry:
    """Get-or-create home for every metric family in the process."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, _MetricFamily] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, factory, kind: str):
        fam = self._metrics.get(name)
        if fam is None:
            with self._lock:
                fam = self._metrics.get(name)
                if fam is None:
                    fam = self._metrics[name] = factory()
        if fam.kind != kind:
            raise TypeError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {kind}"
            )
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(
            name, lambda: Counter(name, help, self), "counter"
        )

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(
            name, lambda: Gauge(name, help, self), "gauge"
        )

    def histogram(
        self, name: str, help: str = "",
        bounds: tuple[float, ...] | None = None,
    ) -> Histogram:
        fam = self._get_or_create(
            name, lambda: Histogram(name, help, self, bounds), "histogram"
        )
        # A family's geometry is fixed by whoever registered it first;
        # silently handing a later caller different buckets than it
        # asked for would corrupt its counts with no error, so conflict
        # is loud (mirrors the kind-mismatch check above).
        if bounds is not None and tuple(bounds) != fam.bounds:
            raise TypeError(
                f"histogram {name!r} already registered with bounds "
                f"{fam.bounds}, requested {tuple(bounds)}"
            )
        return fam

    def families(self) -> list[_MetricFamily]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda f: f.name)

    def snapshot(self) -> dict:
        """The full registry as one JSON-safe dict — the ``metrics``
        protocol op's payload and the extended ``stats()`` source.
        Histogram cells carry p50/p95/p99 precomputed (the caller
        wants quantiles, not raw bucket arrays; ``_counts`` stays for
        tooling that does)."""
        out: dict = {}
        for fam in self.families():
            values = []
            for key, cell in fam.cells():
                labels = dict(key)
                if fam.kind == "histogram":
                    values.append({"labels": labels, **cell.snapshot()})
                else:
                    values.append({"labels": labels, "value": cell.get()})
            out[fam.name] = {
                "type": fam.kind, "help": fam.help, "values": values
            }
            if fam.kind == "histogram":
                # bucket geometry rides the snapshot: an exact merge of
                # several processes' snapshots is only defined over cells
                # sharing edges, and the merge must be able to CHECK
                # that instead of assuming it
                out[fam.name]["bounds"] = list(fam.bounds)
        return out

    def reset(self) -> None:
        """Zero every cell IN PLACE — bound cells held by hot paths
        stay valid (a registry swap would silently orphan them)."""
        for fam in self.families():
            fam.reset()


# -- process-wide default ----------------------------------------------------

_REGISTRY = MetricsRegistry(enabled=True)
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process registry (tests needing full isolation). Hot
    paths that bound cells before the swap keep writing to the OLD
    registry — prefer ``get_registry().reset()`` unless that isolation
    is exactly what you want. Returns the previous registry."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        prev, _REGISTRY = _REGISTRY, registry
    return prev
