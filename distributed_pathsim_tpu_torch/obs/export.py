"""Exporters: Prometheus text exposition + Perfetto trace files.

The registry (metrics.py) and tracer (trace.py) hold live state; this
module is the only place that knows on-disk/wire formats:

- :func:`render_prometheus` — the registry as Prometheus text
  exposition format 0.0.4 (``# HELP``/``# TYPE`` headers, cumulative
  ``_bucket{le=...}`` histogram series, ``_sum``/``_count``);
- :func:`write_textfile` — one atomic snapshot: write to a temp file
  in the target directory, ``os.replace`` over the destination, so a
  node-exporter textfile collector (or a test) can never read a
  half-written scrape;
- :class:`PrometheusTextfileExporter` — a daemon thread re-writing the
  textfile on an interval (``--metrics-file`` on ``dpathsim-torch serve``),
  with a final write on ``stop()`` so shutdown state is never lost;
- :func:`write_chrome_trace` — the tracer ring as Perfetto-loadable
  JSON (delegates to the tracer, which owns the clock anchor).
"""

from __future__ import annotations

import math
import os
import threading

from .metrics import MetricsRegistry, get_registry
from .trace import Tracer, get_tracer


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str], extra: str = "") -> str:
    parts = [
        f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
    ]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def atomic_write(path: str, text: str) -> None:
    """THE atomic file write: temp file in the destination directory
    (``os.replace`` must not cross filesystems) + rename, so no reader
    — a textfile collector, a trace viewer, a dump raced by SIGTERM —
    can ever see half a file. Every obs artifact goes through here."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


def render_prometheus(registry: MetricsRegistry | None = None) -> str:
    """Prometheus text exposition format 0.0.4. Histograms render with
    cumulative ``le`` buckets (underflow folds into the first bound,
    overflow into ``+Inf``), which is exactly how promql's
    ``histogram_quantile`` expects them."""
    registry = registry or get_registry()
    lines: list[str] = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {fam.help or fam.name}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, cell in fam.cells():
            labels = dict(key)
            if fam.kind == "histogram":
                snap = cell.snapshot()
                cum = snap["underflow"]
                for bound, c in zip(cell.bounds, snap["_counts"]):
                    cum += c
                    le = 'le="{}"'.format(_fmt_value(bound))
                    lines.append(
                        f"{fam.name}_bucket{_fmt_labels(labels, le)} {cum}"
                    )
                le_inf = 'le="+Inf"'
                lines.append(
                    f"{fam.name}_bucket{_fmt_labels(labels, le_inf)}"
                    f" {snap['count']}"
                )
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(labels)}"
                    f" {_fmt_value(snap['sum'])}"
                )
                lines.append(
                    f"{fam.name}_count{_fmt_labels(labels)} {snap['count']}"
                )
            else:
                lines.append(
                    f"{fam.name}{_fmt_labels(labels)}"
                    f" {_fmt_value(cell.get())}"
                )
    return "\n".join(lines) + "\n"


def write_textfile(
    path: str, registry: MetricsRegistry | None = None
) -> None:
    """One atomic Prometheus snapshot (see :func:`atomic_write`)."""
    atomic_write(path, render_prometheus(registry))


class IntervalFileExporter:
    """The interval-writer lifecycle, shared by the per-process and
    fleet exporters: a daemon thread calls :meth:`write` every
    ``interval_s`` (plus once at start, so the file is visible
    immediately), swallowing transient OSErrors (metrics export must
    never take the server down — the next interval retries); ``stop()``
    performs a final write so the file always reflects the process's
    last state. Start/stop are idempotent. Subclasses implement
    :meth:`write`."""

    thread_name = "pathsim-export"

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def write(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        # the immediate first write is LOUD: an unwritable path is a
        # config error the operator must see at startup, not a file
        # that silently never appears
        self.write()
        self._thread = threading.Thread(
            target=self._loop, name=self.thread_name, daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write()
            except OSError:
                pass

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        self._thread = None
        try:
            self.write()  # shutdown state preserved
        except OSError:
            pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class PrometheusTextfileExporter(IntervalFileExporter):
    """Background interval writer for the textfile-collector pattern
    (``--metrics-file`` on the per-process CLIs)."""

    thread_name = "pathsim-metrics-export"

    def __init__(
        self,
        path: str,
        interval_s: float = 5.0,
        registry: MetricsRegistry | None = None,
    ):
        super().__init__(interval_s)
        self.path = path
        self._registry = registry

    def write(self) -> None:
        write_textfile(self.path, self._registry)


def write_chrome_trace(path: str, tracer: Tracer | None = None) -> int:
    """Dump the tracer's finished-span ring as Perfetto-loadable JSON;
    returns the number of span events written."""
    return (tracer or get_tracer()).write_chrome_trace(path)
