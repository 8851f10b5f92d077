"""Observability: hierarchical tracing spans and a metrics registry.

Public surface:

- :func:`get_tracer` / :class:`Tracer` / :class:`SpanContext` —
  hierarchical spans with cross-thread context propagation, written as
  Chrome/Perfetto trace-event JSON by :func:`dump_trace` (trace.py);
  :func:`to_wire` / :func:`from_wire` carry span identity and the
  sampling decision on the JSONL protocol's ``trace`` field;
- :func:`get_registry` / :class:`MetricsRegistry` — process-wide
  counters, gauges and bounded-memory streaming histograms, the source
  of the ``metrics`` op's p50/p95/p99 (metrics.py);
- :func:`configure` — the one switch the serve CLI flips.

The JAX package's Prometheus exporter, flight recorder, SLO engine and
fleet merge are not ported yet.

Layering: this package imports nothing from the rest of the port —
everything else imports obs, never the reverse.
"""

from __future__ import annotations

from .metrics import (
    MetricsRegistry,
    geometric_bounds,
    get_registry,
    quantile_from_counts,
    set_registry,
)
from .trace import (
    Span,
    SpanContext,
    Tracer,
    from_wire,
    get_tracer,
    to_wire,
)

__all__ = [
    "MetricsRegistry",
    "Span",
    "SpanContext",
    "Tracer",
    "configure",
    "dump_trace",
    "from_wire",
    "geometric_bounds",
    "get_registry",
    "get_tracer",
    "quantile_from_counts",
    "set_registry",
    "to_wire",
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
    n = get_tracer().write_chrome_trace(path)
    return f"trace: {n} spans -> {path} (load in https://ui.perfetto.dev)"
