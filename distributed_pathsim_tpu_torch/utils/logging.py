"""Run logging: the reference's exact log grammar.

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
byte-diffable against the reference log. (The JAX package's JSONL
metrics channel and runtime events come with the observability slice.)
"""

from __future__ import annotations

import sys
import time
from typing import IO

class RunLogger:
    """Reference-grammar logger: stdout echo + the grammar file."""

    def __init__(self, output_path: str | None = None, echo: bool = True):
        # The grammar file opens lazily on first write: a run that fails
        # during bootstrap, or a mode that never emits the reference
        # grammar (rank-all), must not leave a stray empty file behind.
        self._output_path = output_path
        self._file: IO[str] | None = None
        self._echo = echo
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
        self._close_grammar_file()

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
        # Terminal (unlike overall_done, which leaves the grammar path
        # reopenable for a next run on the same logger): after close(),
        # grammar writes are no-ops.
        self._close_grammar_file()
        self._output_path = None
