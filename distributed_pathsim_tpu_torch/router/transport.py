"""How the router reaches a worker: subprocess pipes or an in-process thread.

Both transports present the same tiny surface to the router core —
``start(on_message, on_death)``, ``send(dict)``, ``kill()``,
``terminate()`` — so the failover/hedging/fencing machinery is tested
against the exact code that runs in production:

- :class:`SubprocessTransport` — a real ``dpathsim-torch worker`` child
  process, JSONL over its stdin/stdout. Death is detected two ways:
  the reader thread sees EOF (process exited → ``on_death``), and any
  ``send`` into a broken pipe raises :class:`WorkerGone`.
- :class:`InprocTransport` — a :class:`~.worker.WorkerRuntime` driven
  by a queue on a daemon thread. ``kill()`` simulates a hard kill
  deterministically: replies are suppressed from that instant (the
  pipe is gone), queued and in-flight requests are lost, ``on_death``
  fires. This is what the chaos tests use — same runtime code, no
  subprocess startup cost, and fault-plan seams fire in-process where
  the test can assert on them.

Thread-safety: ``send`` may be called from any router thread (writer
lock per transport); ``on_message``/``on_death`` are invoked from the
transport's reader thread and must not block for long.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import threading
import time
from typing import Callable

from ..resilience import inject
from ..utils.logging import runtime_event
from .worker import WorkerRuntime

OnMessage = Callable[[str, dict], None]
OnDeath = Callable[[str, str], None]


class WorkerGone(RuntimeError):
    """The transport's peer is dead; the send did not happen."""


class SubprocessTransport:
    """One ``dpathsim-torch worker`` child process.

    ``argv`` is the full child command line (the router CLI builds it
    from its own serving flags); stderr passes through to the parent's
    so worker runtime events stay operator-visible."""

    def __init__(self, worker_id: str, argv: list[str],
                 env: dict | None = None):
        self.worker_id = worker_id
        self.argv = list(argv)
        self.env = dict(env) if env is not None else dict(os.environ)
        self.ready_info: dict | None = None
        self._ready = threading.Event()
        self._proc: subprocess.Popen | None = None
        self._wlock = threading.Lock()
        self._dead = False
        self._on_message: OnMessage | None = None
        self._on_death: OnDeath | None = None

    def start(self, on_message: OnMessage, on_death: OnDeath) -> None:
        self._on_message = on_message
        self._on_death = on_death
        self._proc = subprocess.Popen(
            self.argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=None,  # inherit: worker events reach the operator
            text=True,
            env=self.env,
        )
        threading.Thread(
            target=self._read_loop,
            name=f"pathsim-router-read-{self.worker_id}",
            daemon=True,
        ).start()

    @property
    def alive(self) -> bool:
        return (
            not self._dead
            and self._proc is not None
            and self._proc.poll() is None
        )

    def wait_ready(self, timeout: float = 120.0) -> dict:
        """Block until the worker's ``ready`` event (startup includes a
        backend build + bucket warmup — allow for it). A worker that
        exits before it is ready raises :class:`WorkerGone` at once,
        with its exit code — its stderr (inherited) says why."""
        deadline = time.monotonic() + timeout
        while not self._ready.wait(0.05):
            proc = self._proc
            if proc is not None and proc.poll() is not None:
                raise WorkerGone(
                    f"worker {self.worker_id} exited with code "
                    f"{proc.returncode} before it was ready"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"worker {self.worker_id} not ready in {timeout}s"
                )
        return self.ready_info or {}

    def send(self, obj: dict) -> None:
        proc = self._proc
        if self._dead or proc is None or proc.poll() is not None:
            raise WorkerGone(f"worker {self.worker_id} is dead")
        line = json.dumps(obj) + "\n"
        try:
            with self._wlock:
                proc.stdin.write(line)
                proc.stdin.flush()
        except (BrokenPipeError, OSError) as exc:
            raise WorkerGone(
                f"worker {self.worker_id} pipe broken: {exc}"
            ) from exc

    def _read_loop(self) -> None:
        proc = self._proc
        assert proc is not None and proc.stdout is not None
        for line in proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                runtime_event(
                    "router_worker_garbage", worker_id=self.worker_id,
                    line=line[:120], echo=False,
                )
                continue
            if obj.get("event") == "ready":
                self.ready_info = obj
                self._ready.set()
            if self._on_message is not None:
                try:
                    self._on_message(self.worker_id, obj)
                except Exception as exc:
                    # a handler bug must not kill the reader thread —
                    # that would silently drop every later response
                    runtime_event(
                        "router_handler_error", worker_id=self.worker_id,
                        error=repr(exc),
                    )
        # EOF: the worker exited (clean drain or a crash — the exit
        # code distinguishes them for the death event)
        rc = proc.wait()
        if not self._dead:
            self._dead = True
            if self._on_death is not None:
                self._on_death(self.worker_id, f"exit {rc}")

    def kill(self) -> None:
        """Hard kill (SIGKILL): the chaos path — no drain, no goodbye;
        the reader's EOF delivers the death."""
        if self._proc is not None:
            self._proc.kill()

    def terminate(self) -> None:
        """Graceful stop request (SIGTERM → worker drain)."""
        if self._proc is not None:
            self._proc.terminate()

    def close(self, timeout: float = 10.0) -> None:
        self._dead = True
        proc = self._proc
        if proc is None:
            return
        if proc.poll() is None:
            try:
                self.send_quiet({"op": "shutdown"})
            except Exception:
                pass
            try:
                proc.wait(timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for stream in (proc.stdin, proc.stdout):
            try:
                if stream:
                    stream.close()
            except OSError:
                pass

    def send_quiet(self, obj: dict) -> None:
        """close()'s best-effort goodbye: bypasses the dead-flag guard
        (close sets it first so on_death stays quiet)."""
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        with self._wlock:
            proc.stdin.write(json.dumps(obj) + "\n")
            proc.stdin.flush()


_SHUTDOWN = object()


class InprocTransport:
    """A WorkerRuntime on a thread, for deterministic tests.

    Construction takes the runtime (the caller owns the service and its
    teardown). ``kill()`` makes the loss WINDOW explicit: everything
    queued or in flight at that instant is gone, exactly like a killed
    process — the router's zero-lost-request property is only meaningful
    if the test can create real loss."""

    def __init__(self, worker_id: str, runtime: WorkerRuntime):
        self.worker_id = worker_id
        self.runtime = runtime
        self._q: queue.Queue = queue.Queue()
        self._killed = False
        self._started = False
        self._on_message: OnMessage | None = None
        self._on_death: OnDeath | None = None
        self.ready_info: dict | None = None
        self._ready = threading.Event()

    def start(self, on_message: OnMessage, on_death: OnDeath) -> None:
        self._on_message = on_message
        self._on_death = on_death
        self._started = True
        threading.Thread(
            target=self._loop,
            name=f"pathsim-inproc-worker-{self.worker_id}",
            daemon=True,
        ).start()

    @property
    def alive(self) -> bool:
        return self._started and not self._killed

    def wait_ready(self, timeout: float = 30.0) -> dict:
        # genuinely wait: the loop thread publishes ready_info; a racy
        # empty return here would seed the router with a (None, 0)
        # token and permanently fence the replica
        if not self._ready.wait(timeout):
            raise TimeoutError(
                f"inproc worker {self.worker_id} not ready in {timeout}s"
            )
        return self.ready_info or {}

    def _emit(self, obj: dict) -> None:
        # a killed worker's pipe is gone: replies vanish, they don't
        # arrive late — dedup at the router handles the OTHER race
        # (answer already sent when the kill landed)
        if self._killed:
            return
        if self._on_message is not None:
            try:
                self._on_message(self.worker_id, obj)
            except Exception as exc:
                # same contract as the subprocess reader: a router
                # handler bug must not poison the worker's threads
                runtime_event(
                    "router_handler_error", worker_id=self.worker_id,
                    error=repr(exc),
                )

    def _loop(self) -> None:
        svc = self.runtime.service
        self.ready_info = {
            "event": "ready", "worker_id": self.worker_id, "n": svc.n,
            "backend": svc.backend.name,
            "base_fp": svc.consistency_token[0],
            "delta_seq": svc.consistency_token[1],
        }
        self._ready.set()
        self._emit(self.ready_info)
        while True:
            req = self._q.get()
            if req is _SHUTDOWN or self._killed:
                return
            try:
                directive = self.runtime.handle(req, self._emit)
            except inject.InjectedCrash:
                # the chaos hard-kill: the "process" dies mid-request
                self.kill()
                return
            except Exception as exc:
                # an unhandled exception kills a real worker process
                # too (EOF → on_death) — mirror that, don't hang
                runtime_event(
                    "worker_crash", worker_id=self.worker_id,
                    error=repr(exc),
                )
                self.kill()
                return
            if directive == "shutdown":
                self.runtime.wait_idle()
                return
            if directive == "drain":
                self.runtime.wait_idle()
                self._emit({"event": "drained",
                            "worker_id": self.worker_id, "clean": True})
                self._die("exit 0")
                return

    def send(self, obj: dict) -> None:
        if self._killed:
            raise WorkerGone(f"worker {self.worker_id} is dead")
        self._q.put(obj)

    def kill(self) -> None:
        if self._killed:
            return
        self._killed = True
        # drop everything queued: a killed process never saw it
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._q.put(_SHUTDOWN)  # wake the loop so the thread exits
        if self._on_death is not None:
            self._on_death(self.worker_id, "killed")

    def terminate(self) -> None:
        """Graceful stop: the in-band drain op."""
        self.send({"op": "drain"})

    def _die(self, reason: str) -> None:
        if not self._killed:
            self._killed = True
            if self._on_death is not None:
                self._on_death(self.worker_id, reason)

    def close(self, timeout: float = 10.0) -> None:
        self._killed = True
        self._q.put(_SHUTDOWN)
