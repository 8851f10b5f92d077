"""Graceful degradation: step down the backend chain instead of dying —
and never from the card to the host behind the user's back.

When a backend's init keeps failing transiently even after retries (a
native extension refusing to load, a flaky allocation on attach), a
long-running workload is better served degraded than dead: the streaming
tier steps down to the dense one, and on the host the dense one steps
down to the numpy oracle — slower, but every backend serves the
identical primitives, so results are unchanged. Each step emits a
structured ``degrade`` event (stderr and the ``--metrics`` JSONL) and
counts in ``dpathsim_degrades_total``; ``--no-degrade`` (or
``degrade=False``) restores fail-fast behavior.

The chain depends on the platform:

- ``cpu``: ``torch-sharded → torch → numpy`` and ``torch-sparse →
  torch → numpy``, as the JAX package's ``jax-sharded → jax → numpy``
  and ``jax-sparse → jax → numpy``;
- ``cuda``: ``torch-sharded → torch`` and ``torch-sparse → torch``, all
  on the card. A ``torch`` backend that keeps failing there raises; it
  never steps down to the host's numpy oracle.

Degradation triggers ONLY on the retry policy's transient classes
(``TransientError``, injected faults, I/O errors): a deterministic
config error raises on the first backend, and so do
:class:`~..utils.device.DeviceUnavailable` and CUDA errors
(``torch.AcceleratorError`` — an illegal address poisons the context,
so nothing on the card can be retried in that process).
"""

from __future__ import annotations

from typing import Any

from ..utils.device import DeviceUnavailable
from ..utils.logging import runtime_event
from . import inject
from .policy import RetryPolicy, policy_from_env


def record_degrade(component: str) -> None:
    """The one registration site for ``dpathsim_degrades_total``: every
    degradation seam (the backend chain here, the loader fallback in
    engine.py) counts through this."""
    from ..obs.metrics import get_registry

    get_registry().counter(
        "dpathsim_degrades_total",
        "degradation-chain step-downs by component",
    ).inc(component=component)


# platform → (name → next step down). The host chain ends at the numpy
# f64 oracle; the card's chain ends at the dense torch backend, so work
# asked for on the card stays there.
BACKEND_DEGRADATION: dict[str, dict[str, str]] = {
    "cpu": {"torch-sharded": "torch", "torch-sparse": "torch",
            "torch": "numpy"},
    "cuda": {"torch-sharded": "torch", "torch-sparse": "torch"},
}

# Options only some backends understand; forwarding them down the chain
# would either crash the fallback or silently change its math, so they
# are dropped.
_BACKEND_ONLY_OPTIONS = {
    "tile_rows": ("torch-sparse",),
    "factor_format": ("torch-sparse",),
    "dense_c_budget_bytes": ("torch-sparse",),
    "rect_kernel": ("torch-sparse",),
    "n_devices": ("torch-sharded",),
    "allpairs_strategy": ("torch-sharded",),
    "device": ("torch", "torch-sparse", "torch-sharded"),
    "exact_counts": ("torch", "torch-sparse", "torch-sharded"),
}


def backend_chain(name: str, platform: str = "cpu") -> list[str]:
    """The degradation order starting at ``name`` (inclusive) on
    ``platform`` (``cpu`` or ``cuda``)."""
    steps = BACKEND_DEGRADATION[platform]
    chain = [name]
    while chain[-1] in steps:
        chain.append(steps[chain[-1]])
    return chain


def _options_for(name: str, options: dict[str, Any]) -> dict[str, Any]:
    out = {
        k: v
        for k, v in options.items()
        if k not in _BACKEND_ONLY_OPTIONS or name in _BACKEND_ONLY_OPTIONS[k]
    }
    if name == "numpy" and "dtype" in out:
        import numpy as np

        out["dtype"] = np.dtype(str(out["dtype"]).rsplit(".", 1)[-1])
    return out


def engine_fallback(
    name: str, options: dict[str, Any], platform: str = "cpu"
) -> tuple[str, dict[str, Any]] | None:
    """The backend, with its options, that a serving engine steps down
    to when ``name`` refuses a metapath's chain (an asymmetric chain on
    ``torch-sparse``): the end of ``platform``'s chain, which runs any
    chain. On the card that is ``torch``, given the options it
    understands; on the host the numpy f64 oracle, given only the
    sub-chain memo, as the JAX service builds it. None when ``name`` is
    already the end."""
    to = backend_chain(name, platform)[-1]
    if to == name:
        return None
    if to == "numpy":
        return to, {k: v for k, v in options.items() if k == "subchain_memo"}
    return to, _options_for(to, options)


def _never_retried() -> tuple[type[BaseException], ...]:
    import torch

    accel = getattr(torch, "AcceleratorError", None)
    return (DeviceUnavailable,) + ((accel,) if accel is not None else ())


def create_backend_resilient(
    name: str,
    hin,
    metapath,
    policy: RetryPolicy | None = None,
    degrade: bool = True,
    **options: Any,
):
    """:func:`..backends.base.create_backend` with retries at the
    ``backend_init`` seam and, when ``degrade``, the step-down chain of
    the platform that ``options["device"]`` names (the host when absent)."""
    import torch

    from ..backends.base import create_backend

    policy = policy or policy_from_env()
    policy = policy.replace(
        non_retryable=policy.non_retryable + _never_retried()
    )
    device = options.get("device")
    platform = "cpu" if device is None else torch.device(device).type
    chain = backend_chain(name, platform) if degrade else [name]
    for step, candidate in enumerate(chain):
        opts = _options_for(candidate, options)

        def attempt(candidate=candidate, opts=opts):
            inject.fire("backend_init")
            return create_backend(candidate, hin, metapath, **opts)

        try:
            backend = policy.call(attempt, seam="backend_init")
        except policy.non_retryable:
            raise
        except policy.retryable as exc:
            if candidate == chain[-1]:
                raise
            record_degrade("backend")
            runtime_event(
                "degrade",
                component="backend",
                from_=candidate,
                to=chain[step + 1],
                platform=platform,
                error=repr(exc),
            )
            continue
        if step > 0:
            runtime_event(
                "degraded_backend_active",
                requested=name,
                active=candidate,
                platform=platform,
            )
        return backend
    raise AssertionError("unreachable")  # the loop returns or raises
