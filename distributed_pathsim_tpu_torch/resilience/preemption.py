"""Preemption-aware shutdown: SIGTERM/SIGINT → a latched stop request.

Cloud GPU hosts get preempted; schedulers send SIGTERM and give a grace
window. A signal only sets a flag; the code that owns the work notices
it at a safe point. The serving loop (``serving/protocol.serve_loop``)
turns it into a graceful drain: the current request completes, the
coalescer pipeline flushes, and the process exits 0. A batch caller
can instead call :meth:`PreemptionHandler.check` between units of work,
which raises :class:`Preempted` (exit code :data:`PREEMPTED_EXIT_CODE`,
75, ``EX_TEMPFAIL`` — "transient, try again").

A second signal during the grace drain escalates to ``KeyboardInterrupt``
so a stuck flush can still be killed interactively.
"""

from __future__ import annotations

import os
import signal
import threading

from ..utils.logging import runtime_event

# BSD sysexits EX_TEMPFAIL: the canonical "re-run me later" code.
PREEMPTED_EXIT_CODE = 75


class Preempted(RuntimeError):
    """The run was asked to stop and has flushed what it could.

    ``resumable`` is True when a checkpoint directory holds a manifest a
    restart can pick up from."""

    def __init__(self, message: str, checkpoint_dir: str | None = None):
        super().__init__(message)
        self.checkpoint_dir = checkpoint_dir

    @property
    def resumable(self) -> bool:
        return self.checkpoint_dir is not None


class PreemptionHandler:
    """Latches a stop request from a signal (or programmatically).

    Signal handlers only set a flag — all flushing happens in the
    compute thread at a safe point (between tiles), never inside the
    handler where arbitrary code is unsafe."""

    def __init__(self):
        self._requested = threading.Event()
        self._reason: str | None = None
        self._prev: dict[int, object] = {}

    def install(self, signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
        """Install handlers; returns False (no-op) outside the main
        thread, where CPython forbids signal registration."""
        if self._prev:
            return True
        try:
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread
            self._prev.clear()
            return False
        return True

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        if self._requested.is_set():
            # Second signal: the operator means it — stop waiting for
            # the graceful drain.
            raise KeyboardInterrupt(f"second signal {signum} during drain")
        # Signal context: only async-signal-safe work here. The buffered
        # runtime_event/metric channels are NOT reentrant (the signal
        # may have landed mid-write in the main thread), so operator
        # feedback goes through raw os.write and the structured event is
        # deferred to the compute thread's next check().
        self._reason = f"signal {signum}"
        self._requested.set()
        os.write(2, f"[pathsim:preempt_requested] reason=signal {signum}\n".encode())

    def request(self, reason: str = "requested") -> None:
        if not self._requested.is_set():
            self._reason = reason
            self._requested.set()
            runtime_event("preempt_requested", reason=reason)

    def requested(self) -> bool:
        return self._requested.is_set()

    @property
    def reason(self) -> str | None:
        return self._reason

    def reset(self) -> None:
        self._requested.clear()
        self._reason = None

    def check(self, checkpoint_dir: str | None = None) -> None:
        """Raise :class:`Preempted` iff a stop was requested. Call at
        safe points AFTER in-flight state has been flushed."""
        if self._requested.is_set():
            runtime_event(
                "preempted",
                reason=self._reason,
                checkpoint_dir=checkpoint_dir,
                resumable=checkpoint_dir is not None,
            )
            raise Preempted(
                f"preempted ({self._reason}); "
                + (
                    f"resume with --checkpoint-dir {checkpoint_dir}"
                    if checkpoint_dir is not None
                    else "no checkpoint directory — progress not saved"
                ),
                checkpoint_dir=checkpoint_dir,
            )


# One per process: signals are process-wide.
handler = PreemptionHandler()
