"""Run logging: the reference's exact log grammar + structured metrics.

The reference mirrors the walk/score lines to stdout AND an append-mode
UTF-8 file, but writes the ``***Stage/Overall done`` markers and ``---``
separators to the file only, flushing per stage
(``DPathSim_APVPA.py:24-68`` — ``print`` at :32,:42,:47,:56; file-only
writes at :63-64,:67). We reproduce both channels exactly. File grammar
per stage (see reference ``output/d_pathsim_output_20180417_020445.log:1-6``):

    Source author global walk: <int>
    Pairwise authors walk <target_id>: <int>
    Target author global walk: <int>
    Sim score <source_label> - <target_label>: <float>
    ***Stage done in: <seconds>
    ---
    ...
    ***Overall done in: <seconds>

Float rendering is Python ``str(float)``, same wording — file output is
byte-diffable against the reference log. A JSONL metrics channel carries
the structured runtime events (``runtime_event``) that serving, the
coalescer and delta ingestion emit.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import IO, Any

from ..obs.metrics import get_registry

# -- clock discipline --------------------------------------------------------
#
# Two clocks, two jobs, never mixed: time.time() (wall) is for HUMANS and
# cross-process joins; time.monotonic() is for ORDERING and durations (it
# never steps backward under NTP). Every JSONL event carries both, stamped
# by this one helper — the same monotonic clock the tracer's spans use
# (obs/trace.py), so events and spans join on the ts_mono axis.


def timestamps() -> dict[str, float]:
    """One wall + monotonic stamp pair, read back to back."""
    return {"ts": time.time(), "ts_mono": time.monotonic()}


# -- runtime events (resilience channel) -----------------------------------
#
# Retries, rebuilds, sheds and preemption requests must be VISIBLE — a
# service that silently rebuilt its backend on every update is a
# debugging trap. Every such event goes through runtime_event():
# one structured line on stderr (never stdout — the reference grammar owns
# stdout), plus the JSONL metrics channel when a RunLogger is registered
# as the process-wide sink (the CLI registers its logger for the run),
# plus a per-event counter in the obs registry (the live aggregate the
# ``metrics`` protocol op and the Prometheus textfile expose).

_EVENT_SINK: "RunLogger | None" = None
# One lock for sink swaps AND stderr writes: runtime_event fires from the
# coalescer's worker threads concurrently with the main thread, so an
# unguarded sink swap could emit into a half-closed logger and two stderr
# prints could interleave their characters mid-line.
_EVENT_LOCK = threading.Lock()


def set_event_sink(logger: "RunLogger | None") -> None:
    """Register (or clear, with None) the RunLogger whose JSONL metrics
    channel receives runtime events."""
    global _EVENT_SINK
    with _EVENT_LOCK:
        _EVENT_SINK = logger


def runtime_event(event: str, echo: bool = True, **fields: Any) -> None:
    """Emit one structured resilience/runtime event.

    stderr rendering: ``[pathsim:EVENT] k=v k=v``; machine rendering: a
    metrics-JSONL record ``{"event": EVENT, ...fields}`` on the
    registered sink, plus ``dpathsim_events_total{event=...}`` in the
    obs registry. Values are stringified for stderr but passed through
    for JSONL (callers pre-repr exceptions).

    ``echo=False`` suppresses only the stderr line (the JSONL record
    always lands): high-rate serving events (per-batch accounting,
    sustained load shedding) must not turn the operator channel into
    the bottleneck, but still need to be machine-visible."""
    get_registry().counter(
        "dpathsim_events_total", "runtime_event emissions by event name"
    ).inc(event=event)
    with _EVENT_LOCK:
        if echo:
            rendered = " ".join(f"{k}={v}" for k, v in fields.items())
            # one write call, trailing newline included: the line lands
            # atomically even when worker threads emit concurrently
            sys.stderr.write(f"[pathsim:{event}] {rendered}".rstrip() + "\n")
        if _EVENT_SINK is not None:
            _EVENT_SINK.metric(event=event, **fields)


class RunLogger:
    """Dual-channel logger: reference-grammar text + optional JSONL."""

    def __init__(
        self,
        output_path: str | None = None,
        echo: bool = True,
        metrics_path: str | None = None,
    ):
        # The grammar file opens lazily on first write: a run that fails
        # during bootstrap, or a mode that never emits the reference
        # grammar (rank-all), must not leave a stray empty file behind.
        self._output_path = output_path
        self._file: IO[str] | None = None
        self._echo = echo
        self._metrics: IO[str] | None = (
            open(metrics_path, "a", encoding="utf-8") if metrics_path else None
        )
        # The JSONL channel is written from multiple threads (the CLI's
        # main thread, coalescer workers via runtime_event): one lock
        # keeps each record on its own line and close() race-free.
        self._metrics_lock = threading.Lock()
        self.overall_start = time.perf_counter()

    # -- reference grammar -------------------------------------------------

    def source_global_walk(self, count: int) -> None:
        self._line(f"Source author global walk: {count}")

    def pairwise_walk(self, target_id: str, count: int) -> None:
        self._line(f"Pairwise authors walk {target_id}: {count}")

    def target_global_walk(self, count: int) -> None:
        self._line(f"Target author global walk: {count}")

    def sim_score(self, source_label: str, target_label: str, score: float) -> None:
        self._line(f"Sim score {source_label} - {target_label}: {score}")

    def stage_done(self, seconds: float) -> None:
        self._write(f"***Stage done in: {seconds}\n")
        self._write("---\n")
        self.flush()

    def overall_done(self) -> None:
        self._write(
            f"***Overall done in: {time.perf_counter() - self.overall_start}\n"
        )
        # Only the reference-grammar file ends here; the metrics channel
        # stays open so post-run stage timings (e.g. a following rank-all
        # or all-pairs phase) still land in the JSONL.
        self._close_grammar_file()

    # -- structured channel (new capability) -------------------------------

    def metric(self, **fields: Any) -> None:
        # Both clocks from the one helper (see timestamps()): ts for
        # humans/joins across processes, ts_mono for ordering and
        # joining with span timestamps — a duration must never be
        # computed from ts (wall time steps under NTP).
        stamps = timestamps()
        fields.setdefault("ts", stamps["ts"])
        fields.setdefault("ts_mono", stamps["ts_mono"])
        with self._metrics_lock:
            if self._metrics is not None:
                self._metrics.write(json.dumps(fields) + "\n")
                self._metrics.flush()

    # -- plumbing ----------------------------------------------------------

    def _line(self, text: str) -> None:
        if self._echo:
            print(text)
        self._write(text + "\n")

    def _write(self, text: str) -> None:
        if self._output_path is None:
            return
        if self._file is None:
            self._file = open(self._output_path, "a", encoding="utf-8")
        self._file.write(text)

    def _close_grammar_file(self) -> None:
        # _output_path survives the close: the file opens in append mode,
        # so a library caller reusing one logger for a second
        # run_single_source call transparently reopens and appends —
        # writes after overall_done() must never be dropped silently.
        if self._file is not None:
            self._file.close()
            self._file = None

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()
        sys.stdout.flush()

    def close(self) -> None:
        # Terminal for BOTH channels (unlike overall_done, which leaves
        # the grammar path reopenable for a next run on the same logger):
        # after close(), grammar writes and metric() are both no-ops.
        self._close_grammar_file()
        self._output_path = None
        with self._metrics_lock:
            if self._metrics is not None:
                self._metrics.close()
                self._metrics = None
