"""Sparsity-aware metapath evaluation planner (DESIGN.md §28).

The chain is **data**: :func:`plan_metapath` compiles a
:class:`~.metapath.MetaPath` plus per-factor :class:`FactorStats` (nnz,
density, log2 degree histograms) into an :class:`EvalPlan` — a DP-optimal
association tree over the chain (Atrapos, arXiv:2201.04058) with the
density-propagation cost estimate recorded on every node, so every
ordering choice is auditable. Symmetric metapaths plan the palindromic
half chain (``M = C·Cᵀ``); general chains plan the full product and use
the ``rowsums_general`` right-fold for row sums (a vector fold is already
association-optimal).

The ``execute_*`` / ``fold_*`` functions are the doorway to the
chain-fold primitives. Every ordering choice is **bit-invisible**: path
counts are exact integers in every carry dtype the backends guard (f64 <
2⁵³, f32 < 2²⁴), so any association order produces identical integers.

The knobs (density cutover, DP length cutoff) resolve through the tuning
registry (``plan_density_cutover``, ``plan_dp_max_len``) with the JAX
package's heuristic defaults, 0.25 and 16.

:class:`SubchainCache` is the workload-level sub-chain memo a serving
process shares across its metapath engines: folded sub-chain COO factors
keyed by the content fingerprints of the factors they span, LRU under a
byte budget (``plan_memo_budget_mb``, default 64 MB). It holds COO
entries only; the JAX package's packed entry layouts come with the
packed factor formats (ROADMAP A.3).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np

from . import chain
from . import sparse as sp
from .metapath import MetaPath, Step

# Log2 degree-histogram buckets: bucket b counts nodes with degree in
# [2^(b-1), 2^b); bucket 0 counts degree-0 nodes. 24 buckets cover any
# graph this repo can encode (int32 index spaces).
_DEG_BUCKETS = 24


def _deg_hist(deg: np.ndarray) -> tuple[int, ...]:
    if deg.size == 0:
        return (0,) * _DEG_BUCKETS
    buckets = np.zeros(_DEG_BUCKETS, dtype=np.int64)
    nz = deg[deg > 0]
    buckets[0] = int(deg.size - nz.size)
    if nz.size:
        b = np.minimum(
            np.floor(np.log2(nz)).astype(np.int64) + 1, _DEG_BUCKETS - 1
        )
        np.add.at(buckets, b, 1)
    return tuple(int(x) for x in buckets)


@dataclasses.dataclass(frozen=True)
class FactorStats:
    """Sparsity statistics of one oriented chain factor — everything
    the cost model consumes. ``row_deg``/``col_deg`` are the exact
    per-index degree vectors (excluded from equality/repr: they exist
    so leaf-leaf products can be costed *exactly* via the join-size
    identity Σ_k coldeg_A(k)·rowdeg_B(k); the compressed histograms
    are the auditable summary that lands in plan dumps)."""

    shape: tuple[int, int]
    nnz: int
    density: float
    row_deg_hist: tuple[int, ...]
    col_deg_hist: tuple[int, ...]
    row_deg: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    col_deg: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False
    )


def factor_stats_from_coo(
    rows: np.ndarray, cols: np.ndarray, shape: tuple[int, int]
) -> FactorStats:
    m, n = int(shape[0]), int(shape[1])
    nnz = int(rows.shape[0])
    row_deg = np.bincount(rows, minlength=m).astype(np.int64)
    col_deg = np.bincount(cols, minlength=n).astype(np.int64)
    return FactorStats(
        shape=(m, n),
        nnz=nnz,
        density=nnz / max(m * n, 1),
        row_deg_hist=_deg_hist(row_deg),
        col_deg_hist=_deg_hist(col_deg),
        row_deg=row_deg,
        col_deg=col_deg,
    )


def factor_stats(hin, step: Step) -> FactorStats:
    """Oriented stats for one metapath step against the bound HIN."""
    b = hin.block(step.relationship)
    rows, cols, shape = b.rows, b.cols, b.shape
    if step.reverse:
        rows, cols, shape = cols, rows, (shape[1], shape[0])
    return factor_stats_from_coo(rows, cols, shape)


@dataclasses.dataclass(frozen=True)
class PlanNode:
    """One node of the association tree. ``lo:hi`` is the step span it
    covers; ``est_flops`` is the estimated cost of *this* product
    (0 for leaves), ``total_flops`` the cumulative subtree cost — both
    recorded so a plan dump explains every choice the DP made."""

    lo: int
    hi: int
    shape: tuple[int, int]
    est_nnz: float
    est_density: float
    est_flops: float
    total_flops: float
    step: Step | None = None
    left: "PlanNode | None" = None
    right: "PlanNode | None" = None
    stats: FactorStats | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    def order_tree(self):
        """Hashable nested-tuple association order (leaf = step index)
        — what the jit-per-order caches key on."""
        if self.is_leaf:
            return self.lo
        return (self.left.order_tree(), self.right.order_tree())

    def describe(self, labels: Sequence[str]) -> str:
        if self.is_leaf:
            return labels[self.lo]
        return (
            f"({self.left.describe(labels)}·{self.right.describe(labels)})"
        )

    def to_dict(self, labels: Sequence[str]) -> dict:
        d = {
            "span": [self.lo, self.hi],
            "expr": self.describe(labels),
            "shape": list(self.shape),
            "est_nnz": round(float(self.est_nnz), 3),
            "est_density": float(self.est_density),
            "est_flops": round(float(self.est_flops), 3),
            "total_flops": round(float(self.total_flops), 3),
        }
        if not self.is_leaf:
            d["left"] = self.left.to_dict(labels)
            d["right"] = self.right.to_dict(labels)
        return d


@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """A compiled evaluation plan for one metapath: the association
    tree (over the half chain when ``mode == "half"``, the full chain
    otherwise), the left-to-right baseline cost for comparison, and
    the labels the audit dump renders spans with."""

    metapath: MetaPath
    mode: str  # "half" (symmetric: M = C·Cᵀ) | "general"
    root: PlanNode
    naive_flops: float
    dp: bool  # False: DP skipped (chain over the size cutoff)
    labels: tuple[str, ...]

    @property
    def est_flops(self) -> float:
        return self.root.total_flops

    def order(self) -> str:
        return self.root.describe(self.labels)

    def order_tree(self):
        return self.root.order_tree()

    def steps(self) -> tuple[Step, ...]:
        mp = self.metapath
        return mp.half() if self.mode == "half" else mp.steps

    def summary(self) -> dict:
        return {
            "metapath": self.metapath.name,
            "mode": self.mode,
            "order": self.order(),
            "est_flops": round(float(self.est_flops), 3),
            "naive_flops": round(float(self.naive_flops), 3),
            "dp": self.dp,
        }

    def to_dict(self) -> dict:
        out = self.summary()
        out["tree"] = self.root.to_dict(self.labels)
        return out


# ---------------------------------------------------------------------------
# Cost model: density propagation (Atrapos §4)
# ---------------------------------------------------------------------------


def _product_estimate(
    a: PlanNode, b: PlanNode, dense_cutover: float, cost: str
) -> tuple[float, float, float]:
    """(est_nnz, est_density, est_flops) of A·B under the named cost
    model.

    ``cost="sparse"`` (COO joins — the half-chain fold, delta
    refolds): the expected join size under independent uniform
    placement, 2·nnz(A)·nnz(B)/r scalar mul-adds over the shared
    dimension r; when BOTH operands are leaves the join size is exact
    (Σ_k coldeg_A(k)·rowdeg_B(k)). Past ``dense_cutover`` density on
    both sides the dense model takes over (a near-dense join costs
    like a GEMM, and the sparse estimator under-costs that regime).

    ``cost="dense"`` (the backends' general-chain GEMMs): a dense
    matmul pays 2·m·r·n regardless of zeros, so sparsity must not
    seduce the DP into an order that is only cheap for a format the
    executor does not use.

    Output density propagates either way as 1−(1−dₐ·d_b)^r — the
    standard Boolean-product estimator (Atrapos §4), computed via
    expm1/log1p so near-0 and near-1 densities stay stable; it rides
    every node for the audit dump and the sparse cost of parents."""
    m, r = a.shape
    _, n = b.shape
    p = a.est_density * b.est_density
    if p >= 1.0:
        est_density = 1.0
    else:
        est_density = -math.expm1(r * math.log1p(-min(p, 1.0 - 1e-12)))
    est_density = min(max(est_density, 0.0), 1.0)
    est_nnz = est_density * m * n
    dense_flops = 2.0 * float(m) * float(r) * float(n)
    if cost == "dense":
        return est_nnz, est_density, dense_flops
    if a.est_density >= dense_cutover and b.est_density >= dense_cutover:
        return est_nnz, est_density, dense_flops
    if (
        a.stats is not None
        and b.stats is not None
        and a.stats.col_deg is not None
        and b.stats.row_deg is not None
    ):
        # leaf·leaf: the join size is exact, Σ_k coldeg_A(k)·rowdeg_B(k)
        joins = 2.0 * float(
            a.stats.col_deg.astype(np.float64) @ b.stats.row_deg
        )
    else:
        joins = 2.0 * a.est_nnz * b.est_nnz / max(r, 1)
    return est_nnz, est_density, joins


def _leaf(i: int, st: Step | None, stats: FactorStats) -> PlanNode:
    return PlanNode(
        lo=i,
        hi=i + 1,
        shape=stats.shape,
        est_nnz=float(stats.nnz),
        est_density=float(stats.density),
        est_flops=0.0,
        total_flops=0.0,
        step=st,
        stats=stats,
    )


def _combine(a: PlanNode, b: PlanNode, dense_cutover: float,
             cost: str) -> PlanNode:
    est_nnz, est_density, flops = _product_estimate(a, b, dense_cutover, cost)
    return PlanNode(
        lo=a.lo,
        hi=b.hi,
        shape=(a.shape[0], b.shape[1]),
        est_nnz=est_nnz,
        est_density=est_density,
        est_flops=flops,
        total_flops=a.total_flops + b.total_flops + flops,
        left=a,
        right=b,
    )


def _left_to_right(leaves: list[PlanNode], dense_cutover: float,
                   cost: str) -> PlanNode:
    acc = leaves[0]
    for leaf in leaves[1:]:
        acc = _combine(acc, leaf, dense_cutover, cost)
    return acc


def _dp_order(leaves: list[PlanNode], dense_cutover: float,
              cost: str) -> PlanNode:
    """Classic interval DP over the chain, ties broken toward the
    smallest split (deterministic plans for equal-cost orders)."""
    n = len(leaves)
    best: dict[tuple[int, int], PlanNode] = {
        (i, i + 1): leaves[i] for i in range(n)
    }
    for span in range(2, n + 1):
        for i in range(0, n - span + 1):
            j = i + span
            winner: PlanNode | None = None
            for k in range(i + 1, j):
                cand = _combine(
                    best[(i, k)], best[(k, j)], dense_cutover, cost
                )
                if winner is None or cand.total_flops < winner.total_flops:
                    winner = cand
            best[(i, j)] = winner
    return best[(0, n)]


def _plan_knobs(n: int, length: int, nnz: int) -> tuple[float, int]:
    """(density cutover, DP length cutoff) via the tuning registry —
    the heuristics are the documented defaults (a sparse join costed like
    a GEMM above density 0.25; the interval DP orders chains of up to 16
    factors), so an absent table means exactly the built-in behavior."""
    from .. import tuning

    cutover = float(
        tuning.choose(
            "plan_density_cutover", n=n, v=length, nnz=nnz, default=0.25
        )
    )
    dp_max = int(
        tuning.choose(
            "plan_dp_max_len", n=n, v=length, nnz=nnz, default=16
        )
    )
    return cutover, dp_max


def _record_plan_metrics(plan: EvalPlan) -> None:
    from ..obs.metrics import get_registry

    get_registry().counter(
        "dpathsim_plan_builds_total",
        "evaluation plans compiled, by metapath and factorization mode",
    ).inc(metapath=plan.metapath.name, mode=plan.mode)


def plan_chain(
    stats: Sequence[FactorStats],
    steps: Sequence[Step | None] | None = None,
    dense_cutover: float | None = None,
    dp_max_len: int | None = None,
    cost: str = "sparse",
) -> tuple[PlanNode, float, bool]:
    """Order an arbitrary factor chain: (root, naive_flops, dp_ran).
    The core of :func:`plan_metapath`.
    ``cost`` names the executor's model — "sparse" for COO joins,
    "dense" for GEMM chains (see :func:`_product_estimate`)."""
    if not stats:
        raise ValueError("cannot plan an empty chain")
    if steps is None:
        steps = [None] * len(stats)
    if dense_cutover is None or dp_max_len is None:
        c, d = _plan_knobs(
            stats[0].shape[0], len(stats), sum(s.nnz for s in stats)
        )
        dense_cutover = c if dense_cutover is None else dense_cutover
        dp_max_len = d if dp_max_len is None else dp_max_len
    leaves = [_leaf(i, st, s) for i, (st, s) in enumerate(zip(steps, stats))]
    naive = _left_to_right(leaves, dense_cutover, cost)
    if len(leaves) <= 2 or len(leaves) > dp_max_len:
        return naive, naive.total_flops, False
    root = _dp_order(leaves, dense_cutover, cost)
    return root, naive.total_flops, True


def plan_metapath(
    hin,
    metapath: MetaPath,
    dense_cutover: float | None = None,
    dp_max_len: int | None = None,
) -> EvalPlan:
    """Compile the metapath's evaluation plan against the bound HIN.

    Memoized per (HIN, metapath name, knob overrides) in a side table
    on the frozen HIN, so backends and the half-chain fold share one
    plan per graph instead of re-scanning factor stats."""
    cache = hin.__dict__.get("_eval_plan_cache")
    if cache is None:
        cache = {}
        object.__setattr__(hin, "_eval_plan_cache", cache)
    ck = (metapath.name, dense_cutover, dp_max_len)
    hit = cache.get(ck)
    if hit is not None:
        return hit
    if metapath.is_symmetric:
        steps = metapath.half()
        mode = "half"
        types = metapath.node_types[: len(steps) + 1]
    else:
        steps = metapath.steps
        mode = "general"
        types = metapath.node_types
    stats = [factor_stats(hin, st) for st in steps]
    labels = tuple(
        f"{types[i][0].upper()}{types[i + 1][0].upper()}"
        for i in range(len(steps))
    )
    root, naive, dp = plan_chain(
        stats, steps, dense_cutover=dense_cutover, dp_max_len=dp_max_len,
        # the half chain folds as sparse COO joins; a general chain
        # executes as dense GEMMs in every backend — the cost model
        # must match the executor, not the storage format
        cost=("sparse" if mode == "half" else "dense"),
    )
    plan = EvalPlan(
        metapath=metapath, mode=mode, root=root, naive_flops=naive,
        dp=dp, labels=labels,
    )
    _record_plan_metrics(plan)
    cache[ck] = plan
    return plan


# ---------------------------------------------------------------------------
# Workload-level sub-chain memoization
# ---------------------------------------------------------------------------


def factor_fingerprint(hin, relationship: str) -> str:
    """Content hash of one adjacency block (rows, cols, shape) —
    memoized per HIN instance; a delta produces a new HIN, so patched
    relationships re-hash while untouched ones reuse the parent's
    arrays (same content → same digest → the memo keeps hitting)."""
    cache = hin.__dict__.get("_block_fp_cache")
    if cache is None:
        cache = {}
        object.__setattr__(hin, "_block_fp_cache", cache)
    fp = cache.get(relationship)
    if fp is None:
        b = hin.block(relationship)
        h = hashlib.sha256()
        h.update(f"{relationship}:{b.shape};".encode())
        h.update(np.ascontiguousarray(b.rows, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(b.cols, dtype=np.int64).tobytes())
        fp = cache[relationship] = h.hexdigest()[:16]
    return fp


def _span_key(node: PlanNode, steps: Sequence[Step], hin) -> tuple:
    """Memo key of one plan node: the (relationship, orientation,
    content-fingerprint) triple of every factor in its span, in order.
    Content-addressed, so equal keys denote bit-identical sub-chain
    results whatever plan (or graph epoch) produced them — two plans
    that associate the same span differently still share the entry."""
    return tuple(
        (st.relationship, st.reverse, factor_fingerprint(hin, st.relationship))
        for st in steps[node.lo: node.hi]
    )


class SubchainCache:
    """Workload-level memo of folded sub-chain COO factors.

    LRU under a byte budget; keys are content fingerprints (see
    :func:`_span_key`), so correctness never depends on invalidation —
    ``invalidate_relationships`` exists to *reclaim bytes* eagerly when
    a delta makes entries unreachable, and to make the invalidation
    rule auditable: only sub-chains whose factors changed are dropped.
    Thread-safe: serving lanes fold concurrently.

    ``factor_format`` (the tuning knob) stores entries through the
    packed layouts (ops/packed.py) and charges them at their PACKED
    bytes against the budget — the same budget then holds several times
    more shared sub-chains. Only canonical (sorted, coalesced) entries
    pack, so a warm hit hands back arrays equal to the cold fold's (raw
    leaf blocks — the one non-canonical producer — stay COO)."""

    def __init__(self, budget_bytes: int, factor_format: str = "coo"):
        from . import packed as pkd

        if factor_format not in pkd.FACTOR_FORMATS:
            raise ValueError(
                f"unknown factor format {factor_format!r}; choose from "
                f"{pkd.FACTOR_FORMATS}"
            )
        self.factor_format = str(factor_format)
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._d: OrderedDict[tuple, sp.COOMatrix] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        from ..obs.metrics import get_registry

        reg = get_registry()
        self._m_hits = reg.counter(
            "dpathsim_plan_memo_hits_total", "sub-chain memo hits"
        ).labels()
        self._m_misses = reg.counter(
            "dpathsim_plan_memo_misses_total", "sub-chain memo misses"
        ).labels()
        self._m_evict = reg.counter(
            "dpathsim_plan_memo_evictions_total",
            "sub-chain memo evictions (budget pressure)",
        ).labels()
        self._m_bytes = reg.gauge(
            "dpathsim_plan_memo_bytes", "sub-chain memo resident bytes"
        ).labels()

    @staticmethod
    def _nbytes(c) -> int:
        from . import packed as pkd

        return pkd.factor_bytes(c)

    def _encode(self, c: sp.COOMatrix):
        """Entry representation for storage: packed when the format knob
        says so AND the entry is canonical (a warm hit must hand back
        arrays equal to the cold fold's)."""
        if self.factor_format == "coo":
            return c
        from . import packed as pkd

        if not pkd.is_canonical(c):
            return c
        return pkd.make_factor(c, self.factor_format)

    def get(self, key: tuple) -> sp.COOMatrix | None:
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                self._m_misses.inc()
                return None
            self._d.move_to_end(key)
            self.hits += 1
            self._m_hits.inc()
        from . import packed as pkd

        # decode outside the lock: a packed hit's O(nnz) unpack must not
        # serialize concurrent lanes
        return pkd.as_coo(hit)

    def put(self, key: tuple, c: sp.COOMatrix) -> None:
        if self.budget_bytes <= 0:
            return
        entry = self._encode(c)
        # An entry bigger than half the budget (a huge leaf factor at
        # full graph scale) would evict every interior fold the memo
        # exists for just to store one array the HIN already holds —
        # skip it; the fold recomputes it in O(nnz). Packed entries are
        # charged at their packed bytes.
        if 2 * self._nbytes(entry) > self.budget_bytes:
            return
        with self._lock:
            if key not in self._d:
                self._bytes += self._nbytes(entry)
            self._d[key] = entry
            self._d.move_to_end(key)
            while self._bytes > self.budget_bytes and len(self._d) > 1:
                _, dropped = self._d.popitem(last=False)
                self._bytes -= self._nbytes(dropped)
                self.evictions += 1
                self._m_evict.inc()
            self._m_bytes.set(self._bytes)

    def invalidate_relationships(self, rels) -> int:
        """Drop every entry whose span touches a changed relationship
        — the delta-update invalidation rule. Entries over untouched
        factors survive (and keep hitting, because their content
        fingerprints did not move)."""
        rels = set(rels)
        if not rels:
            return 0
        with self._lock:
            doomed = [
                key for key in self._d
                if any(rel in rels for rel, _, _ in key)
            ]
            for key in doomed:
                self._bytes -= self._nbytes(self._d[key])
                del self._d[key]
            self._m_bytes.set(self._bytes)
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._bytes = 0
            self._m_bytes.set(0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._d),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


def default_memo_budget_bytes(n: int) -> int:
    """The tuned ``plan_memo_budget_mb`` knob → bytes (heuristic
    default 64 MB — comfortably holds every DBLP-schema sub-chain at
    dblp_large scale while staying irrelevant next to the factor
    itself)."""
    from .. import tuning

    mb = float(tuning.choose("plan_memo_budget_mb", n=n, default=64.0))
    return int(mb * (1 << 20))


# ---------------------------------------------------------------------------
# Execution: the chain-evaluation doorway
# ---------------------------------------------------------------------------


def _oriented_coo(hin, st: Step) -> sp.COOMatrix:
    c = sp.coo_from_block(hin.block(st.relationship))
    if st.reverse:
        c = sp.COOMatrix(
            rows=c.cols, cols=c.rows, weights=c.weights,
            shape=(c.shape[1], c.shape[0]),
        )
    return c


def _eval_coo_node(
    node: PlanNode,
    steps: Sequence[Step],
    hin,
    memo: SubchainCache | None = None,
) -> sp.COOMatrix:
    key = _span_key(node, steps, hin) if memo is not None else None
    if memo is not None:
        hit = memo.get(key)
        if hit is not None:
            return hit
    if node.is_leaf:
        out = _oriented_coo(hin, steps[node.lo])
    else:
        a = _eval_coo_node(node.left, steps, hin, memo)
        b = _eval_coo_node(node.right, steps, hin, memo)
        out = sp.matmul_summed(a, b)
    if memo is not None:
        memo.put(key, out)
    return out


def fold_half(
    hin,
    metapath: MetaPath,
    memo: SubchainCache | None = None,
    plan: EvalPlan | None = None,
) -> sp.COOMatrix:
    """Plan-ordered sparse fold of the symmetric half chain → the COO
    factor C every backend binds. Bit-compatible with the historical
    left-to-right fold: single-step halves return the raw oriented
    block (unsummed, exactly as before), multi-step folds coalesce at
    every product, and integer weights make every association order
    produce identical coalesced content. ``memo`` shares sub-chain
    folds across calls (a warm fold equals the cold one bit for bit)."""
    if plan is None:
        plan = plan_metapath(hin, metapath)
    if plan.mode != "half":
        raise ValueError(
            f"metapath {metapath.name} is not symmetric; "
            "fold_half requires the half-chain factorization"
        )
    return _eval_coo_node(plan.root, plan.steps(), hin, memo)


def fold_general(
    hin,
    metapath: MetaPath,
    memo: SubchainCache | None = None,
    plan: EvalPlan | None = None,
) -> sp.COOMatrix:
    """Plan-ordered sparse fold of the FULL chain (general metapaths):
    the commuting matrix M as coalesced COO."""
    if plan is None:
        plan = plan_metapath(hin, metapath)
    steps = plan.steps()
    if plan.mode == "half":
        # M = C·Cᵀ: fold the half, join it with its transpose.
        c = fold_half(hin, metapath, memo=memo, plan=plan)
        ct = sp.COOMatrix(
            rows=c.cols, cols=c.rows, weights=c.weights,
            shape=(c.shape[1], c.shape[0]),
        )
        return sp.matmul_summed(c, ct)
    return _eval_coo_node(plan.root, steps, hin, memo)


def fold_blocks(
    blocks: Sequence[sp.COOMatrix],
    dense_cutover: float | None = None,
) -> sp.COOMatrix:
    """Plan-ordered fold of pre-oriented COO blocks (the delta
    algebra's general-chain refold and any caller that already
    materialized its factors). Stats come from the blocks themselves;
    no memoization (callers hold transient deltas, not graph state)."""
    if len(blocks) == 1:
        return blocks[0]
    stats = [
        factor_stats_from_coo(b.rows, b.cols, b.shape) for b in blocks
    ]
    root, _, _ = plan_chain(stats, dense_cutover=dense_cutover)

    def ev(node: PlanNode) -> sp.COOMatrix:
        if node.is_leaf:
            return blocks[node.lo]
        return sp.matmul_summed(ev(node.left), ev(node.right))

    return ev(root)


def dense_half(
    hin,
    metapath: MetaPath,
    dtype=np.float32,
    memo: SubchainCache | None = None,
) -> np.ndarray:
    """Dense [N, V] half-chain factor via the plan-ordered sparse fold
    (the dense [N, P] intermediate of a naive chain product never
    exists)."""
    coo = fold_half(hin, metapath, memo=memo).summed()
    c = np.zeros(coo.shape, dtype=dtype)
    c[coo.rows, coo.cols] = coo.weights
    return c


def execute_dense_order(order, blocks):
    """Evaluate a dense block chain in the plan's association order
    (``order`` from :meth:`EvalPlan.order_tree`: leaf = block index,
    product = a (left, right) pair). Takes numpy arrays or torch
    tensors alike."""
    if isinstance(order, int):
        return blocks[order]
    left, right = order
    return execute_dense_order(left, blocks) @ execute_dense_order(
        right, blocks
    )


def execute_dense(plan: EvalPlan, blocks):
    """Dense chain product in plan order (the general-metapath M)."""
    return execute_dense_order(plan.order_tree(), blocks)


def naive_dense(blocks):
    """The left-to-right reference fold — the baseline the ordering
    bench compares the planner against (delegates to the seeded
    primitive; this doorway is why callers stay MP001-clean)."""
    return chain.chain_product(blocks)


def rowsums_fold(blocks):
    """Row sums of an arbitrary chain by the right-fold — a vector
    fold is already association-optimal (each step is one GEMV)."""
    return chain.rowsums_general(blocks)
