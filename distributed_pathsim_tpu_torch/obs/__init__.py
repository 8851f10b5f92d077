"""Observability: hierarchical tracing spans, metrics, exporters, fleet.

Public surface:

- :func:`get_tracer` / :class:`Tracer` / :class:`SpanContext` —
  hierarchical spans with cross-thread context propagation, written as
  Chrome/Perfetto trace-event JSON by :func:`dump_trace` (trace.py);
  :func:`to_wire` / :func:`from_wire` carry span identity and the
  sampling decision on the JSONL protocol's ``trace`` field;
- :func:`get_registry` / :class:`MetricsRegistry` — process-wide
  counters, gauges and bounded-memory streaming histograms, the source
  of the ``metrics`` op's p50/p95/p99 (metrics.py);
- :func:`render_prometheus` / :func:`write_textfile` /
  :class:`PrometheusTextfileExporter` / :func:`write_chrome_trace` —
  the on-disk/wire formats (export.py; ``--metrics-file`` on ``serve``
  and ``worker``);
- fleet.py — exact (bucket-wise, associative) merge of per-process
  registry snapshots, per-worker-labeled fleet Prometheus export,
  stitched multi-process Perfetto traces + the parent-link audit, and
  the ``dpathsim-torch fleet-stats`` renderer;
- :class:`SLOEngine` / :class:`SLOSpec` (slo.py) — declarative
  objectives over the merged stream with multi-window burn-rate
  alerts;
- :class:`FlightRecorder` (flight.py) — the tail-sampling complement
  to head sampling: retroactively keep slow/errored/shed/hedged/
  failed-over requests' records and span trees;
- :func:`configure` — the one switch the CLIs flip.

Layering: this package imports nothing from the rest of the port —
everything else imports obs, never the reverse.
"""

from __future__ import annotations

from .export import (
    PrometheusTextfileExporter,
    render_prometheus,
    write_chrome_trace,
    write_textfile,
)
from .fleet import (
    FleetTextfileExporter,
    audit_fleet_traces,
    fleet_chrome_trace,
    merge_histogram_cells,
    merge_registry_snapshots,
    render_fleet_prometheus,
    render_fleet_stats,
    write_fleet_textfile,
    write_fleet_trace,
)
from .flight import FlightRecorder
from .metrics import (
    MetricsRegistry,
    geometric_bounds,
    get_registry,
    quantile_from_counts,
    set_registry,
)
from .slo import SLOEngine, SLOSpec, default_specs, specs_from_json
from .trace import (
    Span,
    SpanContext,
    Tracer,
    from_wire,
    get_tracer,
    to_wire,
)

__all__ = [
    "FleetTextfileExporter",
    "FlightRecorder",
    "MetricsRegistry",
    "PrometheusTextfileExporter",
    "SLOEngine",
    "SLOSpec",
    "Span",
    "SpanContext",
    "Tracer",
    "audit_fleet_traces",
    "configure",
    "default_specs",
    "dump_trace",
    "fleet_chrome_trace",
    "from_wire",
    "geometric_bounds",
    "get_registry",
    "get_tracer",
    "merge_histogram_cells",
    "merge_registry_snapshots",
    "quantile_from_counts",
    "render_fleet_prometheus",
    "render_fleet_stats",
    "render_prometheus",
    "set_registry",
    "specs_from_json",
    "to_wire",
    "write_chrome_trace",
    "write_fleet_textfile",
    "write_fleet_trace",
    "write_textfile",
]


def configure(
    metrics: bool | None = None,
    tracing: bool | None = None,
    max_spans: int | None = None,
    device_annotations: bool | None = None,
    trace_sample: int | None = None,
) -> None:
    """Flip the process-wide observability switches. ``None`` leaves a
    switch untouched. Metrics default ON (aggregation is cheap and the
    ``metrics``/``stats`` ops should always have answers); tracing
    defaults OFF. ``trace_sample=n`` traces every nth request head
    (1 = all)."""
    if metrics is not None:
        get_registry().enabled = metrics
    get_tracer().configure(
        enabled=tracing,
        max_spans=max_spans,
        device_annotations=device_annotations,
        sample_every=trace_sample,
    )


def dump_trace(path: str) -> str:
    """Write the span ring as Perfetto-loadable JSON and return the
    one-line summary the CLI prints at exit."""
    n = write_chrome_trace(path)
    return f"trace: {n} spans -> {path} (load in https://ui.perfetto.dev)"
