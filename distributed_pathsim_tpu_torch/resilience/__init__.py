"""Fault-tolerance primitives of the serving path.

- :mod:`.policy` — :class:`RetryPolicy` (exponential backoff + jitter,
  exception-class filters, overall deadlines; env-tunable defaults) and
  :class:`Deadline`, the per-request time budget the protocol's
  ``deadline_ms`` field becomes;
- :mod:`.preemption` — SIGTERM/SIGINT → a latched stop request, which
  ``serve`` turns into a graceful drain.

The JAX package's fault injector and backend degradation chain are not
ported yet.
"""

from __future__ import annotations

from .policy import (
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    TransientError,
    policy_from_env,
)
from .preemption import PREEMPTED_EXIT_CODE, Preempted, handler as preemption_handler

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "PREEMPTED_EXIT_CODE",
    "Preempted",
    "RetryPolicy",
    "TransientError",
    "policy_from_env",
    "preemption_handler",
]
