"""Threshold similarity join: every pair with PathSim ≥ τ.

The port of the JAX package's ``batch/simjoin.py``.

Naively this is the full N×N score matrix. The campaign instead
certifies most BLOCK PAIRS away with bounds that can only ever
over-estimate a pair's score, so a pruned block provably contains no
qualifying pair — and computes the survivors exactly through the same
``pathsim.score_candidates`` primitive the serving tier uses, so every
emitted score is bit-identical to the oracle's.

The bound (rowsum variant only — the campaign refuses ``diagonal``
loudly). With ``M = C Cᵀ`` and ``d_x = Σ_y M[x,y]``, every ``M[x,y]``
is a non-negative term of both row sums, hence ``M[x,y] ≤ min(d_x,
d_y)``, giving::

    sim(x,y) = 2·M[x,y] / (d_x + d_y) ≤ 2·min(d_x, d_y) / (d_x + d_y)

A pair with either degree zero has ``M[x,y] = 0`` → score 0, so for
τ > 0 it never qualifies and the block bound only needs to cover pairs
where BOTH degrees are positive. For blocks I, J with degree maxima
``hI, hJ`` and positive-degree minima ``lI, lJ``::

    max over (x∈I, y∈J) sim(x,y) ≤ 2·min(hI, hJ) / (lI + lJ)

If that upper bound is < τ — or ``min(hI, hJ) = 0`` (one block is all
isolated rows) — the block pair is pruned, score-safe by construction.
A second independent certificate uses column-support signatures: each
block's bitset OR of its rows' factor supports. Disjoint signatures ⇒
``C[x]·C[y] = 0`` for every cross pair ⇒ all scores are 0 ⇒ pruned.
Grouping rows by degree (default) or by balanced-k-means centroids
(index/mips.py) tightens the intervals; soundness never depends on the
grouping because every bound is computed from the block's ACTUAL
degree stats. Uncertified block pairs fall back to exact computation,
counted (``dpathsim_batch_exact_fallback_total``).

Checkpointing is per row block I: one atomic unit holds all pairs
(I, J≥I) found for that block, so resume granularity, preemption
points, and the stale-graph fence are exactly the topk campaign's
(DESIGN.md §31).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..resilience import preemption_handler
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import runtime_event
from .campaign import BatchEngine, CampaignSpec, _block_key, block_ranges


@dataclasses.dataclass
class SimJoinResult:
    """All qualifying pairs, normalized ``row < col``, in deterministic
    block order (resume-independent: the assembly re-reads units in
    block order, so a preempted+resumed campaign emits the same
    bytes)."""

    spec: CampaignSpec
    rows: np.ndarray        # int64 [P]
    cols: np.ndarray        # int64 [P]
    scores: np.ndarray      # f64  [P]
    blocks_total: int
    blocks_resumed: int
    block_pairs_total: int
    block_pairs_pruned: int
    elapsed_s: float
    rows_per_s: float
    backend_mode: str

    @property
    def prune_ratio(self) -> float:
        return self.block_pairs_pruned / max(self.block_pairs_total, 1)


def _permutation(engine: BatchEngine, grouping: str) -> np.ndarray:
    """Row order the blocks are cut from. ``degree`` packs similar
    degrees together (tight [l, h] intervals → strong bounds);
    ``centroid`` clusters rows with the balanced k-means over the
    dense factor rows (co-clustered supports → disjoint-signature
    prunes). ``natural`` keeps corpus order — the only grouping the
    fleet path uses, since workers address blocks by global row range."""
    if grouping == "natural":
        return np.arange(engine.n, dtype=np.int64)
    if grouping == "degree":
        return np.argsort(engine.d, kind="stable").astype(np.int64)
    if grouping == "centroid":
        from ..index.mips import balanced_kmeans

        emb = np.asarray(
            np.sqrt(np.maximum(engine._ct.T, 0.0)), dtype=np.float32
        )
        k = max(-(-engine.n // engine.block_rows), 1)
        _, assign = balanced_kmeans(
            emb, k=k, cap=engine.block_rows, seed=0,
        )
        return np.argsort(assign, kind="stable").astype(np.int64)
    raise ValueError(f"unknown simjoin grouping {grouping!r}")


def _block_stats(engine: BatchEngine, groups: list[np.ndarray]):
    """One decode pass over the corpus → per-block certificates:
    (dmax, positive-degree dmin, packed column-support bitset)."""
    hmax = np.zeros(len(groups))
    lmin = np.full(len(groups), np.inf)
    sigs = []
    for bi, rows in enumerate(groups):
        bd = engine._gather_dense(rows)
        engine.bytes_decoded += int(np.count_nonzero(bd)) * 24
        db = engine.d[rows]
        hmax[bi] = db.max() if db.size else 0.0
        pos = db[db > 0]
        if pos.size:
            lmin[bi] = pos.min()
        sigs.append(np.packbits((bd != 0).any(axis=0)))
    return hmax, lmin, np.stack(sigs)


def run_simjoin_campaign(
    engine: BatchEngine,
    tau: float,
    checkpoint_dir: str | None = None,
    grouping: str = "degree",
    emit_pairs: str | None = None,
    on_block=None,
    scheduler=None,
) -> SimJoinResult:
    """All pairs with ``sim ≥ τ``, block-pruned and checkpointed.

    Requires ``variant == "rowsum"`` (the prune bound is a rowsum
    identity) and ``τ > 0`` (zero-score pairs are pruned wholesale;
    a τ of 0 would make "every pair" the answer and no bound sound).
    With ``scheduler`` the campaign fans natural-order row blocks
    across the fleet via the ``batch_blocks`` wire op — workers
    compute their blocks exactly (no pruning server-side), so fleet
    results are bit-identical to a pruned single-host run."""
    if engine.variant != "rowsum":
        raise ValueError(
            "simjoin prune bounds are a rowsum identity; "
            f"variant {engine.variant!r} is not supported — run the "
            "topk campaign or score rows directly instead"
        )
    tau = float(tau)
    if not tau > 0.0:
        raise ValueError(f"simjoin requires tau > 0, got {tau}")
    if scheduler is not None and grouping != "natural":
        raise ValueError(
            "fleet simjoin addresses blocks by global row range; "
            f"use grouping='natural' (got {grouping!r})"
        )
    spec = engine.spec("simjoin", tau=tau, grouping=grouping)
    ck = (
        CheckpointManager(checkpoint_dir, config=spec.manifest_config())
        if checkpoint_dir else None
    )
    perm = _permutation(engine, grouping)
    blocks = block_ranges(engine.n, engine.block_rows)
    groups = [perm[lo:hi] for lo, hi in blocks]
    nb = len(blocks)
    mem: dict[str, dict] = {}
    reg = get_registry()
    g_blocks = reg.gauge(
        "dpathsim_batch_blocks", "campaign blocks by completion state",
    )
    g_prune = reg.gauge(
        "dpathsim_batch_prune_ratio",
        "fraction of simjoin block pairs pruned by certificates",
    )
    c_exact = reg.counter(
        "dpathsim_batch_exact_fallback_total",
        "simjoin block pairs no certificate could prune "
        "(computed exactly)",
    )
    c_pairs = reg.counter(
        "dpathsim_batch_pairs_total", "simjoin qualifying pairs emitted",
    )
    tracer = get_tracer()
    t0 = time.perf_counter()
    resumed = sum(
        1 for lo, hi in blocks
        if ck is not None and ck.is_done(_block_key(lo, hi))
    )
    g_blocks.set(float(nb), state="total")
    g_blocks.set(float(resumed), state="done")
    done = resumed
    pruned_bp = 0
    exact_bp = 0
    stats = None

    def _save(lo: int, hi: int, ii, jj, ss, meta):
        nonlocal done
        arrays = {
            "ii": np.asarray(ii, dtype=np.int64),
            "jj": np.asarray(jj, dtype=np.int64),
            "ss": np.asarray(ss, dtype=np.float64),
            "meta": np.asarray(meta, dtype=np.int64),
        }
        key = _block_key(lo, hi)
        if ck is not None:
            ck.save_unit(key, **arrays)
        else:
            mem[key] = arrays
        done += 1
        g_blocks.set(float(done), state="done")
        c_pairs.inc(float(arrays["ii"].shape[0]))
        if on_block is not None:
            on_block(done, nb)
        preemption_handler.check(checkpoint_dir=checkpoint_dir)

    with tracer.span(
        "batch.campaign", mode="simjoin", tau=tau,
        grouping=grouping, blocks=nb, resumed=resumed,
    ):
        if scheduler is not None:
            pending = [
                (lo, hi) for lo, hi in blocks
                if not (ck is not None and ck.is_done(_block_key(lo, hi)))
            ]
            for lo, hi, result in scheduler.map_blocks(spec, pending):
                with tracer.span("batch.block", lo=lo, hi=hi):
                    _save(
                        lo, hi, result["rows"], result["cols"],
                        result["scores"], [0, 0],
                    )
        else:
            for bi, (lo, hi) in enumerate(blocks):
                key = _block_key(lo, hi)
                if ck is not None and ck.is_done(key):
                    unit = ck.load_unit(key)
                    pruned_bp += int(unit["meta"][0])
                    exact_bp += int(unit["meta"][1])
                    continue
                if stats is None:
                    stats = _block_stats(engine, groups)
                hmax, lmin, sigs = stats
                with tracer.span("batch.block", lo=lo, hi=hi):
                    ii: list[np.ndarray] = []
                    jj: list[np.ndarray] = []
                    ss: list[np.ndarray] = []
                    bp_pruned = 0
                    bp_exact = 0
                    gi = groups[bi]
                    for bj in range(bi, nb):
                        num_cap = min(hmax[bi], hmax[bj])
                        if num_cap <= 0.0:
                            bp_pruned += 1
                            continue
                        bound = 2.0 * num_cap / (lmin[bi] + lmin[bj])
                        if bound < tau:
                            bp_pruned += 1
                            continue
                        if not np.any(sigs[bi] & sigs[bj]):
                            bp_pruned += 1
                            continue
                        bp_exact += 1
                        c_exact.inc()
                        gj = groups[bj]
                        sc = engine.sweep_pair_block(gi, gj)
                        if bi == bj:
                            # the diagonal owns each unordered pair
                            # once: keep the strictly-upper triangle
                            # in GLOBAL ids (self pairs excluded too)
                            keep = sc >= tau
                            keep &= gi[:, None] < gj[None, :]
                        else:
                            keep = sc >= tau
                        xi, yj = np.nonzero(keep)
                        if xi.size:
                            a, b = gi[xi], gj[yj]
                            ii.append(np.minimum(a, b))
                            jj.append(np.maximum(a, b))
                            ss.append(sc[xi, yj])
                    pruned_bp += bp_pruned
                    exact_bp += bp_exact
                    _save(
                        lo, hi,
                        np.concatenate(ii) if ii else np.empty(0, np.int64),
                        np.concatenate(jj) if jj else np.empty(0, np.int64),
                        np.concatenate(ss) if ss else np.empty(0),
                        [bp_pruned, bp_exact],
                    )
    elapsed = time.perf_counter() - t0
    ii_all, jj_all, ss_all = [], [], []
    for lo, hi in blocks:
        key = _block_key(lo, hi)
        unit = ck.load_unit(key) if ck is not None else mem[key]
        ii_all.append(unit["ii"])
        jj_all.append(unit["jj"])
        ss_all.append(unit["ss"])
    rows = np.concatenate(ii_all) if ii_all else np.empty(0, np.int64)
    cols = np.concatenate(jj_all) if jj_all else np.empty(0, np.int64)
    scores = np.concatenate(ss_all) if ss_all else np.empty(0)
    bp_total = nb * (nb + 1) // 2
    if bp_total:
        g_prune.set(pruned_bp / bp_total)
    result = SimJoinResult(
        spec=spec, rows=rows, cols=cols, scores=scores,
        blocks_total=nb, blocks_resumed=resumed,
        block_pairs_total=bp_total, block_pairs_pruned=pruned_bp,
        elapsed_s=elapsed,
        rows_per_s=engine.n * max(nb - resumed, 0) / max(nb, 1)
        / max(elapsed, 1e-9),
        backend_mode=(
            "fleet" if scheduler is not None else engine.backend_mode
        ),
    )
    if emit_pairs:
        with open(emit_pairs, "w", encoding="utf-8") as f:
            for r, c, s in zip(rows, cols, scores):
                f.write(json.dumps(
                    {"row": int(r), "col": int(c), "score": float(s)}
                ) + "\n")
    runtime_event(
        "batch_simjoin_done", echo=False, tau=tau, grouping=grouping,
        pairs=int(rows.shape[0]), blocks=nb, resumed=resumed,
        pruned_block_pairs=pruned_bp, exact_block_pairs=exact_bp,
        prune_ratio=round(result.prune_ratio, 4),
    )
    return result
