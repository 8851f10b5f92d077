"""Retry policies: exponential backoff + jitter, class filters, deadlines.

The stack's failure seams (GEXF load, metapath compile, backend init,
per-tile execute, checkpoint I/O, multi-host rendezvous) all share one
failure taxonomy: *transient* faults — a flaky native loader, a rejected
remote compile (the HTTP 413 incident in git history), a preempted host,
a full-then-freed disk — deserve a bounded, backed-off retry; *semantic*
faults (bad metapath, wrong checkpoint directory) must surface on the
first attempt. :class:`RetryPolicy` encodes that split once so every
seam behaves identically and every retry is visible as a structured
``runtime_event``.

Defaults come from the environment so an operator can harden a flaky
deployment without touching call sites::

    PATHSIM_MAX_RETRIES=5 PATHSIM_RETRY_BASE_DELAY=0.2 dpathsim ...
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Callable, TypeVar

from ..obs.metrics import get_registry
from ..utils.logging import runtime_event

T = TypeVar("T")


class TransientError(Exception):
    """A failure worth retrying: the operation may succeed if repeated.

    Raised directly by the fault injector and usable by any subsystem
    that can classify its own failures (e.g. a remote compile service
    returning a retryable status)."""


# What a retry can plausibly fix. ValueError/KeyError (user input,
# schema mismatches) are deliberately absent: retrying a deterministic
# error just triples its latency.
DEFAULT_RETRYABLE: tuple[type[BaseException], ...] = (
    TransientError,
    OSError,
    ConnectionError,
    TimeoutError,
)

# Jitter is deterministic by default (seeded RNG): chaos runs and tests
# reproduce byte-for-byte. Operators fighting thundering herds across a
# pod set PATHSIM_RETRY_SEED to the process rank (or any varying value).
_rng = random.Random(int(os.environ.get("PATHSIM_RETRY_SEED", "0")))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with jitter and an overall deadline.

    ``max_attempts`` counts the first try: 3 means one try + two
    retries. ``deadline_s`` bounds the *total* time spent inside
    :meth:`call` — an attempt whose next backoff would overrun the
    deadline is not slept for; the last error raises instead.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25  # ± fraction of the nominal delay
    deadline_s: float | None = None
    retryable: tuple[type[BaseException], ...] = DEFAULT_RETRYABLE
    non_retryable: tuple[type[BaseException], ...] = ()

    def replace(self, **changes) -> "RetryPolicy":
        return dataclasses.replace(self, **changes)

    def backoff(self, attempt: int) -> float:
        """Nominal delay after the ``attempt``-th failure (1-based),
        before jitter."""
        return min(
            self.base_delay * self.multiplier ** (attempt - 1), self.max_delay
        )

    def _jittered(self, delay: float) -> float:
        if self.jitter <= 0:
            return delay
        return delay * (1.0 + self.jitter * (2.0 * _rng.random() - 1.0))

    def call(self, fn: Callable[[], T], seam: str = "") -> T:
        """Run ``fn`` under this policy. Non-retryable and unknown
        exception classes propagate immediately; retryable ones are
        retried with backoff until attempts or the deadline run out."""
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        t0 = time.monotonic()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except self.non_retryable:
                raise
            except self.retryable as exc:
                if attempt >= self.max_attempts:
                    raise
                delay = self._jittered(self.backoff(attempt))
                if (
                    self.deadline_s is not None
                    and time.monotonic() - t0 + delay > self.deadline_s
                ):
                    runtime_event(
                        "retry_deadline",
                        seam=seam,
                        attempt=attempt,
                        deadline_s=self.deadline_s,
                        error=repr(exc),
                    )
                    raise
                get_registry().counter(
                    "dpathsim_retries_total", "retries by failure seam"
                ).inc(seam=seam or "unknown")
                runtime_event(
                    "retry",
                    seam=seam,
                    attempt=attempt,
                    max_attempts=self.max_attempts,
                    delay_s=round(delay, 4),
                    error=repr(exc),
                )
                time.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover


class Deadline:
    """An absolute time budget, propagated end-to-end.

    Born at the protocol edge from a request's ``deadline_ms`` field and
    threaded through every layer that might wait, retry, or re-dispatch
    (router failover, hedged sends, worker dispatch): each hop asks for
    the *remaining* budget, so the sum of all retries can never overshoot
    what the caller asked for. Monotonic-clock based — wall steps under
    NTP must not expire (or resurrect) a request."""

    __slots__ = ("t_deadline",)

    def __init__(self, budget_s: float):
        self.t_deadline = time.monotonic() + float(budget_s)

    @classmethod
    def from_ms(cls, deadline_ms: float | None) -> "Deadline | None":
        """Protocol field → Deadline; None/absent means unbounded."""
        if deadline_ms is None:
            return None
        return cls(float(deadline_ms) / 1e3)

    def remaining_s(self) -> float:
        return self.t_deadline - time.monotonic()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def clamp(self, policy: "RetryPolicy") -> "RetryPolicy":
        """Bound a retry policy by the remaining budget: the tighter of
        the policy's own deadline and this one wins, so a seam's
        environment-tuned deadline can shrink but never extend what the
        caller granted."""
        remaining = max(self.remaining_s(), 0.0)
        if policy.deadline_s is None or policy.deadline_s > remaining:
            return policy.replace(deadline_s=remaining)
        return policy


class DeadlineExceeded(RuntimeError):
    """The caller's time budget ran out before an answer was produced.

    NOT a TransientError: retrying an expired request only wastes the
    replica a failover would have handed it to."""


def _env_float(name: str, default: float | None) -> float | None:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return float(raw)


def policy_from_env(**overrides) -> RetryPolicy:
    """The environment-tuned default policy; ``overrides`` win over env,
    env wins over the dataclass defaults."""
    fields = {
        "max_attempts": int(os.environ.get("PATHSIM_MAX_RETRIES", "3")),
        "base_delay": _env_float("PATHSIM_RETRY_BASE_DELAY", 0.05),
        "max_delay": _env_float("PATHSIM_RETRY_MAX_DELAY", 2.0),
        "deadline_s": _env_float("PATHSIM_RETRY_DEADLINE", None),
    }
    fields.update({k: v for k, v in overrides.items() if v is not None})
    return RetryPolicy(**fields)
