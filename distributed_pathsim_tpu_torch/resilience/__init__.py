"""Fault-tolerance primitives: the batch CLI's failure seams (GEXF load,
metapath compile, backend init, per-tile execute, checkpoint write,
device execute), the serving path and the router tier.

- :mod:`.policy` — :class:`RetryPolicy` (exponential backoff + jitter,
  exception-class filters, overall deadlines; env-tunable defaults) and
  :class:`Deadline`, the per-request time budget the protocol's
  ``deadline_ms`` field becomes;
- :mod:`.inject` — :class:`FaultInjector`: the deterministic chaos
  harness (``PATHSIM_FAULT_PLAN``) that raises, delays or requests
  preemption at the router tier's seams (``worker_dispatch``,
  ``heartbeat``, ``delta_broadcast``) and at the batch seams, so every
  recovery path runs on the CPU in the tests;
- :mod:`.degrade` — the backend step-down chain (``torch-sparse →
  torch → numpy`` on the host; ``torch-sparse → torch`` on the card,
  which never moves work to the host) and the loader fallback counter;
- :mod:`.preemption` — SIGTERM/SIGINT → a latched stop request, which
  ``serve`` and ``worker`` turn into a graceful drain and the streaming
  sweep into a checkpoint flush and exit 75.

The one-line integration surface for seams is :func:`resilient_call`.
"""

from __future__ import annotations

from typing import Callable, TypeVar

from . import degrade, inject
from .degrade import backend_chain, create_backend_resilient, engine_fallback
from .inject import FaultInjector, InjectedCrash, InjectedFault
from .policy import (
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    TransientError,
    policy_from_env,
)
from .preemption import PREEMPTED_EXIT_CODE, Preempted, handler as preemption_handler

T = TypeVar("T")

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "FaultInjector",
    "InjectedCrash",
    "InjectedFault",
    "PREEMPTED_EXIT_CODE",
    "Preempted",
    "RetryPolicy",
    "TransientError",
    "backend_chain",
    "create_backend_resilient",
    "degrade",
    "engine_fallback",
    "inject",
    "policy_from_env",
    "preemption_handler",
    "resilient_call",
]


def resilient_call(
    seam: str,
    fn: Callable[[], T],
    policy: RetryPolicy | None = None,
) -> T:
    """Run ``fn`` as one seam attempt: consult the fault injector, then
    the real work, under ``policy`` (env default when None). Each retry
    attempt re-fires the injector — an injected fault counts as a
    failure of the operation itself."""
    policy = policy or policy_from_env()

    def attempt() -> T:
        inject.fire(seam)
        return fn()

    return policy.call(attempt, seam=seam)
