"""Deterministic chaos harness: inject faults at the stack's seams.

A recovery path (a retry, a failover, a fenced replica's catch-up) is
testable on the CPU because its seam consults a process-wide
:class:`FaultInjector` before doing real work. The plan is
env/config-driven and *deterministic*: a rule fires on specific
pass-counts through its seam, never on wall time or randomness, so a
chaos run is exactly reproducible.

The grammar and the seam vocabulary are the JAX package's, so one plan
string means the same thing to both packages. In the port the router
tier fires ``worker_dispatch``, ``heartbeat`` and ``delta_broadcast``;
the other seams are named for the batch-path modules that will fire
them once they are ported.

Plan grammar (``PATHSIM_FAULT_PLAN``)::

    plan  := entry ("," entry)*
    entry := seam ":" kind [":" count ["@" skip] [":" arg]]

- ``seam``: one of :data:`SEAMS` (e.g. ``tile_execute``).
- ``kind``: ``error`` (raise :class:`InjectedFault` — retryable),
  ``crash`` (raise :class:`InjectedCrash` — NON-retryable, simulates a
  hard kill), ``delay`` (sleep ``arg`` seconds, default 0.01),
  ``partial`` (checkpoint writes only: truncate the temp file mid-write,
  then raise :class:`InjectedFault` — exercises write atomicity),
  ``preempt`` (request graceful preemption, as if SIGTERM arrived).
- ``count``: how many fires consume this rule (default 1).
- ``@skip``: let this many fires through first (default 0) — e.g.
  ``tile_execute:crash:1@2`` crashes on the THIRD tile.

Example — one transient failure at every seam::

    PATHSIM_FAULT_PLAN="gexf_load:error:1,metapath_compile:error:1,\
backend_init:error:1,tile_execute:error:1,checkpoint_write:partial:1"
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import IO

from ..utils.logging import runtime_event
from .policy import TransientError

ENV_VAR = "PATHSIM_FAULT_PLAN"

# The failure seams. fire() accepts any name — new seams shouldn't need
# a registry edit to be testable — but the plan parser warns on unknown
# ones to catch typos.
SEAMS = (
    "gexf_load",
    "metapath_compile",
    "backend_init",
    "tile_execute",
    "device_execute",
    "checkpoint_write",
    "multihost_init",
    # Horizontal serving tier (router/): fired by a worker before each
    # query dispatch, by the router before each heartbeat probe, and by
    # the router before each per-worker delta send. An ``error`` at
    # worker_dispatch is a retriable per-request failure the router
    # reroutes; a ``delay`` simulates a stalled worker (hedging
    # territory); an ``error`` at delta_broadcast makes that worker
    # miss the update — the fencing machinery's test vector.
    "worker_dispatch",
    "heartbeat",
    "delta_broadcast",
)

_KINDS = ("error", "crash", "delay", "partial", "preempt")


class InjectedFault(TransientError):
    """A transient injected failure — retry policies absorb it."""


class InjectedCrash(RuntimeError):
    """A hard injected failure — never retried, kills the run like a
    real crash so checkpoint/resume paths can be exercised."""


@dataclasses.dataclass
class FaultRule:
    seam: str
    kind: str
    count: int = 1
    skip: int = 0
    arg: float | None = None
    fired: int = 0
    skipped: int = 0

    def consume(self) -> bool:
        """Whether this rule claims the current fire (and advance its
        skip/fire bookkeeping)."""
        if self.fired >= self.count:
            return False
        if self.skipped < self.skip:
            self.skipped += 1
            return False
        self.fired += 1
        return True


def parse_plan(plan: str) -> list[FaultRule]:
    rules: list[FaultRule] = []
    for raw in plan.split(","):
        entry = raw.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad fault-plan entry {entry!r}: need seam:kind[:count[@skip]][:arg]"
            )
        seam, kind = parts[0].strip(), parts[1].strip()
        if kind not in _KINDS:
            raise ValueError(
                f"bad fault-plan entry {entry!r}: unknown kind {kind!r} "
                f"(choose from {_KINDS})"
            )
        if seam not in SEAMS:
            runtime_event("fault_plan_unknown_seam", seam=seam, entry=entry)
        count, skip = 1, 0
        if len(parts) >= 3 and parts[2].strip():
            count_part = parts[2].strip()
            if "@" in count_part:
                c, s = count_part.split("@", 1)
                count, skip = int(c), int(s)
            else:
                count = int(count_part)
        arg = float(parts[3]) if len(parts) >= 4 and parts[3].strip() else None
        rules.append(FaultRule(seam=seam, kind=kind, count=count, skip=skip, arg=arg))
    return rules


class FaultInjector:
    """Holds the active rules plus per-seam hit counters.

    Hit counters tick on EVERY fire (rules or not): tests use them to
    assert e.g. that a resumed run re-executed only the unfinished
    tiles. The counters are cheap (one dict increment per seam pass, on
    paths that each do device dispatches or file I/O)."""

    def __init__(self, rules: list[FaultRule] | None = None):
        self.rules = rules or []
        self.hits: dict[str, int] = {}
        self.events: list[dict] = []

    @classmethod
    def from_plan(cls, plan: str) -> "FaultInjector":
        return cls(parse_plan(plan))

    @property
    def active(self) -> bool:
        return any(r.fired < r.count for r in self.rules)

    def _record(self, rule: FaultRule) -> None:
        ev = {
            "seam": rule.seam,
            "kind": rule.kind,
            "hit": self.hits.get(rule.seam, 0),
        }
        self.events.append(ev)
        from ..obs.metrics import get_registry

        get_registry().counter(
            "dpathsim_faults_injected_total",
            "chaos-harness faults fired, by seam and kind",
        ).inc(seam=rule.seam, kind=rule.kind)
        runtime_event("fault_injected", **ev)

    def fire(self, seam: str) -> None:
        """Called by a seam before (each attempt of) its real work.
        Applies at most one matching rule per fire."""
        self.hits[seam] = self.hits.get(seam, 0) + 1
        for rule in self.rules:
            if rule.seam != seam or rule.kind == "partial":
                continue  # partial is claimed by corrupt_stream()
            if not rule.consume():
                continue
            self._record(rule)
            if rule.kind == "error":
                raise InjectedFault(f"injected transient fault at {seam}")
            if rule.kind == "crash":
                raise InjectedCrash(f"injected crash at {seam}")
            if rule.kind == "delay":
                time.sleep(rule.arg if rule.arg is not None else 0.01)
                return
            if rule.kind == "preempt":
                from . import preemption

                preemption.handler.request(reason=f"injected at {seam}")
                return
        return

    def corrupt_stream(self, seam: str, f: IO[bytes]) -> None:
        """Partial-write injection point: called by atomic writers with
        the still-open temp file AFTER the payload is written. A pending
        ``partial`` rule truncates the file to half and raises — the
        rename never happens, so this simulates a writer dying mid-write
        (what the atomic temp+rename discipline exists to survive)."""
        for rule in self.rules:
            if rule.seam != seam or rule.kind != "partial":
                continue
            if not rule.consume():
                continue
            # no hit increment here: the enclosing save already fire()d
            self._record(rule)
            f.flush()
            size = f.tell()
            f.truncate(max(size // 2, 0))
            raise InjectedFault(f"injected partial write at {seam}")


# -- process-wide injector --------------------------------------------------
#
# None means "not yet resolved from the environment"; tests install an
# explicit injector (overriding env) and reset() back afterwards.

_injector: FaultInjector | None = None


def get_injector() -> FaultInjector:
    global _injector
    if _injector is None:
        plan = os.environ.get(ENV_VAR, "")
        _injector = FaultInjector.from_plan(plan) if plan else FaultInjector()
    return _injector


def install_plan(plan: str) -> FaultInjector:
    """Install an explicit plan (tests/chaos harness), overriding the
    environment. Returns the injector so callers can inspect hits."""
    global _injector
    _injector = FaultInjector.from_plan(plan)
    return _injector


def reset() -> None:
    """Drop the active injector; the next fire() re-reads the env."""
    global _injector
    _injector = None


def fire(seam: str) -> None:
    get_injector().fire(seam)


def corrupt_stream(seam: str, f: IO[bytes]) -> None:
    get_injector().corrupt_stream(seam, f)
