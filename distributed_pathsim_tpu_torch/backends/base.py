"""Backend interface and registry.

A backend binds an :class:`EncodedHIN` + compiled :class:`MetaPath` and
serves the two primitives the reference's algorithm layer is built from
(``DPathSim_APVPA.py:70-109``), batched:

- ``global_walks()`` — the "global walk" count for EVERY source node at
  once (row sums of the commuting matrix M; the reference runs one
  distributed join per node for this)
- ``pairwise_row(s)`` — ``M[s, :]``, the "pairwise walk" count from source
  ``s`` to EVERY target at once (the reference runs one join per pair)

plus all-pairs conveniences. The ``--backend`` flag routes through
:func:`get_backend` / :func:`create_backend`. Registered here: ``torch``
(the dense device backend, ``torch_dense.py``), ``torch-sparse`` (the
streaming row-tiled device backend, ``torch_sparse.py``),
``torch-sharded`` (the row-sharded multi-device backend,
``torch_sharded.py``) and ``numpy`` (the host f64 oracle).
"""

from __future__ import annotations

import abc
import time
from typing import Any, Callable

import numpy as np

from ..data.encode import EncodedHIN
from ..ops import planner
from ..ops.metapath import MetaPath
from ..ops import pathsim


class DeltaUnsupported(RuntimeError):
    """The backend has no incremental-update path for this chain shape
    (e.g. an asymmetric metapath: no half factor to patch). Callers fall
    back to a full rebuild — a capability miss, never a correctness
    failure."""


class PathSimBackend(abc.ABC):
    """Common surface for all execution backends.

    **Capacity invariant**: the bound HIN may reserve index headroom
    (data/delta.py) — adjacency blocks then have padded shapes and the
    backend's device/host arrays are built at capacity. Every
    host-visible result (rows, sums, matrices, scores) is trimmed to
    the LOGICAL size ``n_sources`` / ``n_targets``, so padding is
    invisible to callers and results are bit-identical to an unpadded
    build (padded factor rows hold no edges, so they contribute zero
    counts everywhere)."""

    name: str = "abstract"

    def __init__(self, hin: EncodedHIN, metapath: MetaPath, **options: Any):
        self.hin = hin
        self.metapath = metapath
        # the constructor's keyword options: subclasses add their named
        # ones, so a rebuild over a delta-applied graph (the serving
        # layer's fallback) replays exactly this configuration
        self.options = options
        # The chain is data: every backend executes an EvalPlan —
        # DP-ordered association over the (half-)chain with estimated
        # FLOPs/density on every node (ops/planner.py, DESIGN.md §28).
        # Plan construction is memoized per (HIN, metapath), so N
        # backends over one graph share one stats scan.
        self.plan = planner.plan_metapath(hin, metapath)
        # Workload-level sub-chain memo (serving passes the shared
        # SubchainCache so concurrent metapath engines share folds).
        self._subchain_memo = options.get("subchain_memo")

    def describe_plan(self) -> dict:
        """The auditable plan dump: association order + per-node cost
        estimates (the ``stats()``/bench surface of plan choices)."""
        return self.plan.to_dict()

    def factor_info(self) -> dict | None:
        """Resident factor accounting (``stats()["factor"]``):
        ``{"format", "bytes", "nnz", "coo_bytes"}``, or None for
        backends with no resident sparse factor."""
        return None

    @property
    def n_sources(self) -> int:
        """Logical source-node count (never the padded capacity). Read
        dynamically: a delta update can append nodes."""
        return self.hin.type_size(self.metapath.source_type)

    @property
    def n_targets(self) -> int:
        """Logical target-node count (== n_sources for symmetric
        chains; the column-axis trim for asymmetric ones)."""
        return self.hin.type_size(self.metapath.target_type)

    # -- primitives (each backend implements) -----------------------------

    @abc.abstractmethod
    def global_walks(self) -> np.ndarray:
        """Row sums of M for every source node: float[N], integer-valued."""

    @abc.abstractmethod
    def pairwise_row(self, source_index: int) -> np.ndarray:
        """M[source, :]: float[N], integer-valued."""

    @abc.abstractmethod
    def commuting_matrix(self) -> np.ndarray:
        """The full M (dense). Backends for huge graphs may refuse."""

    # -- derived ----------------------------------------------------------

    def diagonal(self) -> np.ndarray:
        return np.diagonal(self.commuting_matrix()).copy()

    def _denominators(self, variant: str) -> np.ndarray:
        if variant == "rowsum":
            return self.global_walks()
        if variant == "diagonal":
            return self.diagonal()
        raise ValueError(f"unknown variant {variant!r}")

    def scores_from_source(
        self, source_index: int, variant: str = "rowsum"
    ) -> np.ndarray:
        # Counts are exact integers whatever the carry dtype (guarded ≤
        # 2^24 for f32); normalizing in f64 on host makes the scores
        # carry-dtype-independent.
        d = np.asarray(self._denominators(variant), dtype=np.float64)
        row = np.asarray(self.pairwise_row(source_index), dtype=np.float64)
        return pathsim.score_row(row, d[source_index], d, xp=np)

    # -- batched multi-row path ---------------------------------------------
    #
    # Every row of a batched result is bit-identical to the unbatched
    # call for that row: (a) path counts are exact integers under each
    # backend's dtype guard, so any summation order yields the same
    # numbers, and (b) normalization + top-k selection run through the
    # same f64 host code either way.

    def pairwise_rows(self, rows) -> np.ndarray:
        """M[rows, :] stacked: float[B, N], integer-valued. Backends
        override with one batched dispatch; the fallback loops."""
        return np.stack(
            [
                np.asarray(self.pairwise_row(int(r)), dtype=np.float64)
                for r in np.asarray(rows, dtype=np.int64)
            ]
        )

    def scores_rows(self, rows, variant: str = "rowsum") -> np.ndarray:
        """Score rows for a batch of sources: f64 [B, N]."""
        rows = np.asarray(rows, dtype=np.int64)
        d = np.asarray(self._denominators(variant), dtype=np.float64)
        m = np.asarray(self.pairwise_rows(rows), dtype=np.float64)
        return pathsim.score_rows(m, d[rows], d, xp=np)

    def topk_rows(self, rows, k: int = 10, variant: str = "rowsum"):
        """Batched per-source top-k: (values f64 [B, k], indices int64
        [B, k]), self pairs excluded, ordered (descending score,
        ascending column) — the oracle tie order. ``k`` is clamped to
        N−1 (a self pair can never rank)."""
        rows = np.asarray(rows, dtype=np.int64)
        scores = self.scores_rows(rows, variant=variant)
        scores[np.arange(rows.shape[0]), rows] = -np.inf
        return pathsim.topk_from_score_rows(
            scores, min(k, max(scores.shape[1] - 1, 1))
        )

    def topk_row(self, row: int, k: int = 10, variant: str = "rowsum"):
        """Single-source top-k — the B=1 case of :meth:`topk_rows`
        (identical code path, so batched vs unbatched can never
        diverge)."""
        vals, idxs = self.topk_rows(
            np.asarray([row], dtype=np.int64), k=k, variant=variant
        )
        return vals[0], idxs[0]

    def all_pairs_scores(self, variant: str = "rowsum") -> np.ndarray:
        m = np.asarray(self.commuting_matrix(), dtype=np.float64)
        rowsums = (
            np.asarray(self.global_walks(), dtype=np.float64)
            if variant == "rowsum"
            else None
        )
        return pathsim.score_matrix(m, rowsums=rowsums, variant=variant, xp=np)

    # -- incremental updates (delta ingestion, data/delta.py) --------------

    def check_delta(self, plan) -> None:
        """Raise, before anything changes, when absorbing ``plan`` would
        break this backend's exactness guard. The backends without one
        (the f64 oracle; the streaming tier, which rescores exactly past
        the guard) accept every plan."""

    def apply_delta(self, plan) -> None:
        """Absorb one :class:`~..data.delta.DeltaPlan` in place: patch
        the half factor, denominators and derived caches from the plan's
        signed ΔC instead of rebuilding — O(Δ + affected rows), and every
        patched array keeps its shape (that's what the capacity headroom
        buys).

        Raises :class:`DeltaUnsupported` when this backend/chain has no
        patch path; the caller (PathSimService.update) falls back to a
        full rebuild. A ``fallback`` plan is a caller bug — the plan
        already decided this delta must rebuild."""
        if plan.fallback:
            raise ValueError(
                f"plan requires full rebuild ({plan.reason}); "
                "apply_delta must not be called with a fallback plan"
            )
        impl = getattr(self, "_apply_delta_impl", None)
        if impl is None:
            raise DeltaUnsupported(
                f"backend {self.name!r} has no incremental update path"
            )
        impl(plan)
        self.hin = plan.hin_new


_REGISTRY: dict[str, Callable[..., PathSimBackend]] = {}


def register_backend(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_backend(name: str) -> Callable[..., PathSimBackend]:
    # Import side-effect registration for the built-ins on first use.
    from . import (  # noqa: F401
        numpy_backend, torch_dense, torch_sharded, torch_sparse)

    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_backends() -> list[str]:
    from . import (  # noqa: F401
        numpy_backend, torch_dense, torch_sharded, torch_sparse)

    return sorted(_REGISTRY)


def create_backend(
    name: str, hin: EncodedHIN, metapath: MetaPath, **options: Any
) -> PathSimBackend:
    """Construct a registered backend, visible to obs: init count and
    duration land in the registry (a serving process rebuilding
    backends at delta-fallback rate shows up as a moving
    ``dpathsim_backend_inits_total``), and the init runs inside a
    ``backend.init`` span."""
    from ..obs.metrics import get_registry
    from ..obs.trace import get_tracer

    t0 = time.perf_counter()
    with get_tracer().span("backend.init", backend=name):
        backend = get_backend(name)(hin, metapath, **options)
    reg = get_registry()
    reg.counter(
        "dpathsim_backend_inits_total", "backend constructions by name"
    ).inc(backend=name)
    reg.histogram(
        "dpathsim_backend_init_seconds", "backend construction duration"
    ).observe(time.perf_counter() - t0, backend=name)
    return backend
