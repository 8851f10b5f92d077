"""Shared benchmark estimator: interleaved arms, median-of-best.

The JAX package's estimator (``distributed_pathsim_tpu/utils/
benchrunner.py``), copied so the port imports nothing of that package;
the same numbers give the same outputs. On a shared host the baseline
drifts up to 3x between reps, so (a) comparison arms are
**interleaved** — round r runs every arm once, in a fixed order, so a
drift window hits all arms roughly equally instead of poisoning
whichever arm happened to run last — and (b) the point estimate is
**median-of-best**: external load only ever *slows* a run down (noise
is additive), so the fastest samples are the least-contended windows,
and the median over the fastest half is robust both to drift (which
the best samples dodge) and to a single lucky fluke (which a bare min
would canonize).

This module knows nothing of CUDA and times on the host clock. An arm
that launches work on the card finishes it before it returns (a
``torch.cuda.synchronize`` or a fetch to the host): an arm that returns
at launch times the launch, not the kernel.

Consumers: the offline autotuner (``tuning/autotuner.py``) and its
sweep (``tuning/sweep.py``).
"""

from __future__ import annotations

import math
import time
from statistics import median
from typing import Any, Callable, Mapping, Sequence, TypeVar

__all__ = [
    "best_arm", "interleave", "median", "median_of_best", "noise_bound",
    "paired_ratio", "summarize", "time_interleaved",
]

T = TypeVar("T")


def interleave(
    arms: Mapping[str, Callable[[], T]], reps: int
) -> dict[str, list[T]]:
    """Run every arm once per round, ``reps`` rounds, in the mapping's
    fixed order. Returns each arm's per-round results. This is the
    drift-spreading half of the estimator; it collects whatever the
    arms return (timings, stats dicts, …)."""
    out: dict[str, list[T]] = {name: [] for name in arms}
    for _ in range(reps):
        for name, fn in arms.items():
            out[name].append(fn())
    return out


def median_of_best(xs: Sequence[float], keep_frac: float = 0.5) -> float:
    """Median of the fastest ``keep_frac`` of the samples (at least
    one). The estimator of record for arm comparisons — see module
    docstring for why neither the bare median (drift-inflated) nor the
    bare min (one lucky scheduler window) is it."""
    s = sorted(xs)
    keep = max(1, math.ceil(len(s) * keep_frac))
    return median(s[:keep])


def summarize(times_s: Sequence[float]) -> dict[str, float]:
    """The standard per-arm summary: every artifact records all three
    estimates so a reader can see when drift was larger than the effect
    being measured (median far from median_of_best = noisy run)."""
    return {
        "reps": len(times_s),
        "best_ms": min(times_s) * 1e3,
        "median_ms": median(times_s) * 1e3,
        "median_of_best_ms": median_of_best(times_s) * 1e3,
        "worst_ms": max(times_s) * 1e3,
    }


def time_interleaved(
    arms: Mapping[str, Callable[[], Any]],
    reps: int,
    warmup: int = 1,
) -> dict[str, dict[str, float]]:
    """Wall-time each arm ``reps`` times, interleaved, after ``warmup``
    untimed calls per arm (compiles and cache fills must not be
    attributed to the first round). Each round rotates its starting
    arm: with a fixed order, box load that correlates with the round
    phase (periodic background work, allocator/cache state left by the
    previous round's last arm) taxes the same position every round and
    interleaving alone can't cancel it. Returns per-arm summaries plus
    the raw samples (``times_ms``) for the artifact."""
    for _ in range(warmup):
        for fn in arms.values():
            fn()
    names = list(arms)
    samples: dict[str, list[float]] = {name: [] for name in arms}
    for r in range(max(1, reps)):
        start = r % len(names)
        for name in names[start:] + names[:start]:
            fn = arms[name]
            t0 = time.perf_counter()
            fn()
            samples[name].append(time.perf_counter() - t0)
    out: dict[str, dict[str, float]] = {}
    for name, ts in samples.items():
        s = summarize(ts)
        s["times_ms"] = [t * 1e3 for t in ts]
        out[name] = s
    return out


def paired_ratio(
    results: Mapping[str, Mapping[str, Any]],
    arm: str,
    versus: Sequence[str],
) -> float:
    """Median over rounds of ``arm``'s time divided by the fastest of
    ``versus`` in the SAME round — the paired comparison interleaving
    exists to enable. Box drift moves whole rounds (a round's arms run
    within one load window), so the within-round ratio cancels drift
    that aggregate estimates like median-of-best can only bound; use
    this for accept/regress gates between arms, and median-of-best for
    absolute per-arm numbers. Requires ``time_interleaved`` results
    (the raw ``times_ms`` samples)."""
    if not versus:
        raise ValueError("paired_ratio needs at least one versus arm")
    times = results[arm]["times_ms"]
    ratios = [
        t / max(min(results[v]["times_ms"][r] for v in versus), 1e-12)
        for r, t in enumerate(times)
    ]
    return median(ratios)


def best_arm(results: Mapping[str, Mapping[str, float]]) -> str:
    """The winning arm by median-of-best, deterministic tie-break on
    the arm name."""
    return min(
        results, key=lambda name: (results[name]["median_of_best_ms"], name)
    )


def noise_bound(results: Mapping[str, Mapping[str, float]],
                floor: float = 0.05) -> float:
    """A relative noise envelope for 'within noise' gates: the largest
    per-arm spread between the median and median-of-best estimates
    (drift that survived interleaving), floored so a suspiciously quiet
    run still gets a sane tolerance."""
    rel = floor
    for r in results.values():
        base = max(r["median_of_best_ms"], 1e-9)
        rel = max(rel, (r["median_ms"] - base) / base)
    return rel
