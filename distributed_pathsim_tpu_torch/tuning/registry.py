"""Candidate registry: the port's measured decision points, as keyed
knobs.

Runtime code asks :func:`~distributed_pathsim_tpu_torch.tuning.choose`
for a knob's value and passes its own heuristic as the default, so a
missing or unusable table means exactly the untuned behavior. Each knob
keeps the JAX package's name, key format and untuned default, and is
registered here only where the port has its decision point today:

- ``plan_density_cutover`` / ``plan_dp_max_len``: ops/planner.py;
- ``sparse_tile_rows`` / ``sparse_nnz_floor`` / ``factor_format``:
  backends/torch_sparse.py (``factor_format``'s arms: ``coo``,
  ``blocked``, ``bitpacked``, ops/packed.py);
- ``serve_buckets``: serving/service.py;
- ``plan_memo_budget_mb``: the serving sub-chain memo
  (ops/planner.py ``default_memo_budget_bytes``);
- ``compact_chain_len`` / ``compact_headroom``: background compaction
  (serving/compact.py);
- ``batch_block_rows``: the batch campaigns' sweep block height
  (batch/campaign.py);
- ``ring_kernel``: the sharded ring step (parallel/sharded.py
  ``resolve_ring_kernel``). Its one arm is ``rect-cuda`` (K3): the torch
  fold is a plain version and runs only where K3 rejects the shape, so a
  table's other arm on a K3-feasible shape (the JAX ``jnp-fold``) counts
  as a ``fallback`` lookup;
- ``ann_centroids`` / ``ann_cluster_cap``: the MIPS index build
  (index/build.py); ``ann_probe_variant`` / ``ann_nprobe`` /
  ``ann_cand_mult``: the ANN serving lane (serving/service.py);
- ``learned_cand_mult`` / ``learned_conf_floor`` /
  ``learned_refresh_deltas``: the learned serving lane
  (serving/service.py); ``learned_dim`` / ``learned_neg_ratio`` shape
  the trainer's towers (``dpathsim-torch learned train`` and the
  service's in-process distillation).

- ``twopass_stripe_tiles``: column tiles per K1 stripe
  (ops/cuda_kernels.twopass_stripe_tiles, the ``stripe_tiles=`` of
  ``topk_twopass_candidates``); ``rect_target_units``: the (row block,
  stripe) units K3's grid aims for (ops/cuda_kernels.rect_stripe_tiles,
  the ``stripe_tiles=`` of ``topk_rect_candidates``). They are the
  port's counterparts of the JAX package's Pallas tile knobs: runtime
  parameters of the hand-written kernels, keyed on (N, V), whose
  defaults are the untuned heuristics. A tuned value the shape cannot
  take (below 1, wider than the factor, or a candidate buffer over the
  budget) counts as a ``fallback`` lookup and the heuristic runs.

The JAX package's Pallas tile and variant knobs (``scores_variant``,
``scores_tile``, ``topk_rowtile``, ``k_tile``) have no port arm and are
not registered: K2's and K4's tiles are compile-time wgmma shapes
(csrc/u8_tile.cuh, BM 128 / BN 64), and an "xla" arm would put a
kernel's plain version on the card's path.

Every knob is **bit-invisible by construction**: choices only move work
between tilings that share the exact integer-count + f64-normalize
scoring primitives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable decision point: a name, a short contract, and
    ``candidates``: context → the JSON-serializable choices an autotuner
    may measure (context keys: n, v, nnz, dtype, max_batch)."""

    name: str
    doc: str
    candidates: Callable[[dict], list[Any]]


def _twopass_stripe_candidates(ctx: dict) -> list[int]:
    """K1's stripe widths in column tiles and, for a given N, its untuned
    width (ops/cuda_kernels.default_twopass_stripe_tiles) and the whole
    factor's width (one stripe), less those wider than the factor's
    column tiles and, when the context names ``k`` and
    ``budget_bytes``, those whose candidate buffer would pass the budget
    (ops/cuda_kernels.candidate_budget_bytes)."""
    widths = [8, 16, 32, 64, 128, 256]
    if ctx.get("n") is None:
        return widths
    from ..ops import cuda_kernels as ck

    n = int(ctx["n"])
    n_ct = -(-n // ck.TILE)
    k, budget = ctx.get("k"), ctx.get("budget_bytes")
    widths = sorted({*widths, ck.default_twopass_stripe_tiles(n), n_ct})
    return [
        w for w in widths
        if w <= n_ct and (
            k is None or budget is None
            or n * ck._rect_n_stripes(n, w) * int(k) * 8 <= budget)
    ]


KNOBS: dict[str, Knob] = {
    k.name: k
    for k in (
        Knob(
            name="sparse_tile_rows",
            doc="torch-sparse streaming row-tile height: rows of C per "
            "K3 launch of the rank-all sweep and per densified tile "
            "(memory/throughput trade at a given N, V, density).",
            candidates=lambda ctx: [
                t for t in (1024, 2048, 4096, 8192)
                if ctx.get("n") is None or t <= 4 * int(ctx["n"])
            ],
        ),
        Knob(
            name="sparse_nnz_floor",
            doc="floor of the pow-2 per-tile scatter-pad bucket in "
            "TiledHalfChain: a higher floor wastes pad entries but keeps "
            "more delta-drifted nnz inside one scatter shape.",
            candidates=lambda ctx: [1, 1024, 4096, 16384],
        ),
        Knob(
            name="plan_density_cutover",
            doc="metapath planner cost model: intermediate density at "
            "which a factor is costed as DENSE (2·m·r·n GEMM FLOPs) "
            "instead of the sparse join estimate. Affects only the "
            "plan's ORDER choice — integer path counts are "
            "association-invariant, so every order is bit-identical.",
            candidates=lambda ctx: [0.05, 0.1, 0.25, 0.5],
        ),
        Knob(
            name="plan_dp_max_len",
            doc="metapath planner DP size cutoff: chains longer than "
            "this skip the O(L³) interval DP and evaluate left-to-right "
            "(recorded on the plan as dp=False).",
            candidates=lambda ctx: [4, 8, 16, 32],
        ),
        Knob(
            name="plan_memo_budget_mb",
            doc="workload-level sub-chain memo budget (MB): folded "
            "sub-chain COO factors shared across concurrent metapath "
            "lanes (ops/planner.SubchainCache). Bigger budgets keep "
            "more shared prefixes resident across deltas; keys are "
            "content fingerprints, so the budget trades bytes for "
            "hit rate, never correctness.",
            candidates=lambda ctx: [16.0, 64.0, 256.0],
        ),
        Knob(
            name="factor_format",
            doc="resident layout of the sparse half-chain factor "
            "(ops/packed.py): 'coo' (24 B/nnz, zero transform cost), "
            "'blocked' (chunked CSR, hub-first permuted narrow-dtype "
            "columns + narrow integer counts), 'bitpacked' (blocked plus "
            "per-block fixed-width bit-packing of delta-encoded column "
            "ids). Trades decode time per tile/patch for resident bytes. "
            "Bit-invisible: every accessor returns original ids and "
            "exact f64 integers.",
            candidates=lambda ctx: ["coo", "blocked", "bitpacked"],
        ),
        Knob(
            name="batch_block_rows",
            doc="batch-campaign sweep block height (batch/campaign.py): "
            "rows decoded + GEMM'd per block of a topk-all / simjoin "
            "sweep. Taller blocks amortize the resident Cᵀ operand over "
            "more rows but coarsen the checkpoint/preemption granularity "
            "and the simjoin prune intervals. Snapped to the pow-2 "
            "ladder, so every block of a campaign has one shape. "
            "Bit-invisible: counts are exact integers in f64.",
            candidates=lambda ctx: [128, 256, 512, 1024],
        ),
        Knob(
            name="compact_chain_len",
            doc="background-compaction chain trigger (serving/"
            "compact.py): deltas absorbed since the last re-encode "
            "before a compaction is scheduled. Shorter chains bound "
            "cache-version drift and keep the replay log tiny but pay "
            "the off-path rebuild more often. Bit-invisible: "
            "compaction re-encodes the SAME logical graph (token, "
            "fingerprints and caches preserved).",
            candidates=lambda ctx: [64, 256, 1024],
        ),
        Knob(
            name="compact_headroom",
            doc="fresh capacity reserve of a compaction re-encode, as "
            "a fraction of the logical size (padded to pow-2 "
            "buckets): more headroom buys fewer headroom-triggered "
            "compactions per appended node at more resident padding. "
            "Results bit-identical by the padding invariant "
            "(data/delta.py with_headroom).",
            candidates=lambda ctx: [0.25, 0.5, 1.0],
        ),
        Knob(
            name="ring_kernel",
            doc="sharded ring-step score-and-extract: K3 (the rect "
            "two-pass kernel) wherever it takes the shape; the torch "
            "fold (bit-identical tie breaks) runs only where K3 rejects "
            "it (k >= 16) and on the host, whatever a table says "
            "(parallel/ring.ring_topk_step).",
            candidates=lambda ctx: ["rect-cuda"],
        ),
        Knob(
            name="twopass_stripe_tiles",
            doc="column tiles (of 128) per K1 stripe: each row's top-k "
            "restarts per stripe, so wider stripes cost K1 less "
            "selection, while the candidate buffer (and pass 2's input) "
            "is N·ceil(N / stripe)·k entries. Bit-invisible: pass 2 "
            "reduces any stripe layout to the same top-k.",
            candidates=_twopass_stripe_candidates,
        ),
        Knob(
            name="rect_target_units",
            doc="(128-row block, column stripe) units K3's grid aims for "
            "when it sets its stripe width: more units balance the card "
            "better, wider stripes restart each row's list less often "
            "and leave pass 2 fewer candidates. Bit-invisible, as for "
            "twopass_stripe_tiles.",
            candidates=lambda ctx: [256, 512, 1024, 2048],
        ),
        Knob(
            name="ann_centroids",
            doc="MIPS index centroid count as a multiplier on √N "
            "(index/build.default_centroids): more centroids → "
            "smaller clusters → cheaper probes but weaker cluster "
            "locality (recall needs more nprobe).",
            candidates=lambda ctx: [0.5, 1.0, 2.0],
        ),
        Knob(
            name="ann_cluster_cap",
            doc="packed-cluster capacity (pad-to) of the MIPS index "
            "blocks: probe cost is nprobe·cap·dim, so a tight cap is "
            "cheaper per probe but spills more members off their "
            "nearest centroid (recall). Feasibility (K·cap ≥ N) is "
            "re-checked at build; an infeasible tuned cap is raised "
            "loudly, never trusted.",
            candidates=lambda ctx: [64, 128, 256, 512],
        ),
        Knob(
            name="ann_probe_variant",
            doc="ANN candidate generation strategy: 'rerank-all' "
            "routes only (centroid top-nprobe + member ids) and "
            "exact-reranks every probed member against packed "
            "per-cluster count blocks (wins when the half-chain "
            "width V is narrow — the rerank matmul is cheaper than "
            "embedding-space scoring); 'shortlist' scores the probed "
            "embedding blocks in one batched matmul and exact-reranks "
            "only the top cand_mult·k (wins at wide V / on matmul "
            "hardware). Both are exact-reranked, both bit-identical "
            "when the true top-k is covered.",
            candidates=lambda ctx: ["rerank-all", "shortlist"],
        ),
        Knob(
            name="ann_nprobe",
            doc="clusters probed per ANN query: the recall/latency "
            "dial of candidate generation. Arms failing the recall "
            "floor are excluded by the tuner, not merely slow.",
            candidates=lambda ctx: [8, 16, 32, 48, 64, 96],
        ),
        Knob(
            name="ann_cand_mult",
            doc="candidate multiplier: C = mult·k candidates survive "
            "the probe into the exact f64 rerank. Larger mult buys "
            "recall at O(C·V) rerank cost per query.",
            candidates=lambda ctx: [4, 8, 16, 32],
        ),
        Knob(
            name="learned_dim",
            doc="learned-tower output width (the trainer's; the port "
            "serves towers of any width): probe cost per query is "
            "O(N·dim) and checkpoint bytes O(N·dim + F·hidden); wider "
            "towers separate candidates better (recall at a fixed "
            "cand_mult) but cost latency. Bit-invisible: towers only "
            "SHORTLIST — every answer is exact-f64 reranked, so dim "
            "moves recall/latency, never a served score.",
            candidates=lambda ctx: [16, 32, 64],
        ),
        Knob(
            name="learned_neg_ratio",
            doc="uniform-negative fraction of distillation training "
            "slates (1 - HARD_FRAC): more uniform negatives teach "
            "global score calibration, more exact-teacher hard "
            "candidates sharpen the top of the ranking the serving "
            "shortlist is cut from. Arms are judged by shadow "
            "score-recall at the shipped cand_mult.",
            candidates=lambda ctx: [0.25, 0.5, 0.75],
        ),
        Knob(
            name="learned_cand_mult",
            doc="learned candidate multiplier: C = mult·k shortlist "
            "survivors enter the exact f64 rerank (same recall-vs-"
            "rerank-cost dial as ann_cand_mult, against tower "
            "similarities instead of MIPS probes).",
            candidates=lambda ctx: [8, 16, 32, 64],
        ),
        Knob(
            name="learned_refresh_deltas",
            doc="background tower-refresh cadence: deltas absorbed "
            "between re-embed passes (serving/service.refresh_towers). "
            "Every landing fences its affected rows onto the exact "
            "path immediately, so a longer cadence batches the "
            "half-chain fold at the cost of more queries degrading "
            "meanwhile — speed, never correctness.",
            candidates=lambda ctx: [1, 4, 16],
        ),
        Knob(
            name="learned_conf_floor",
            doc="shadow score-recall floor of the learned confidence "
            "gate: measured recall below it disables the learned arm "
            "(every query degrades ann-then-exact, counted) until a "
            "refresh resets the gate. Higher floors trade learned-arm "
            "uptime for tighter worst-case recall.",
            candidates=lambda ctx: [0.95, 0.98, 0.99],
        ),
        Knob(
            name="serve_buckets",
            doc="serving bucket-ladder geometry driven at warmup: "
            "'pow2' (1,2,4,…; <2x pad waste, log2(B)+1 shapes) vs "
            "'coarse' (1 + powers of 4; about half the shapes and warm "
            "time, <4x pad waste).",
            candidates=lambda ctx: ["pow2", "coarse"],
        ),
    )
}


def resolve_ladder(geometry: str, max_batch: int) -> tuple[int, ...]:
    """A ``serve_buckets`` choice → concrete ascending bucket ladder
    covering ``max_batch``. Shared by the serving warmup and the
    coalescer so geometry names can never drift."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if geometry == "pow2":
        step = 2
    elif geometry == "coarse":
        step = 4
    else:
        raise ValueError(f"unknown bucket geometry {geometry!r}")
    ladder = [1]
    while ladder[-1] < max_batch:
        ladder.append(ladder[-1] * step)
    return tuple(ladder)


# ---------------------------------------------------------------------------
# Knob defaults and sanctioned tile/bucket constants (analysis TN001)
# ---------------------------------------------------------------------------
#
# Hardcoded tile/bucket constants outside this registry are exactly how
# untuned heuristics fossilize, so the lint (``dpathsim-torch lint``,
# rule TN001) rejects NEW ones: any module-level or class-level
# integer/tuple constant whose name looks like a tile or bucket knob must
# either be a registered knob's untuned default (KNOB_DEFAULTS, which
# names the knob: the lint lets it stand only while KNOBS registers that
# knob) or appear in SANCTIONED_CONSTANTS with its justification. Each
# sanctioned entry is one of: (a) a kernel-internal layout invariant
# that is NOT a performance choice (tile shapes the CUDA sources are
# compiled for, packing factors), or (b) the fallback floor a heuristic
# returns when tuning is absent — the registry's own documented default.

KNOB_DEFAULTS: dict[str, dict[str, str]] = {
    "ops/cuda_kernels.py": {
        # K3's grid aim (and K1's untuned width:
        # cuda_kernels.default_twopass_stripe_tiles)
        "RECT_TARGET_UNITS": "rect_target_units",
    },
}

SANCTIONED_CONSTANTS: dict[str, frozenset[str]] = {
    "ops/cuda_kernels.py": frozenset({
        "TILE",       # kernel layout: the row block every kernel is
        # compiled for (csrc/u8_tile.cuh BM) and the unit of K1's and
        # K3's column stripes — a wgmma tile shape, not a tuned choice
        "SUBTILE",    # kernel layout: the subtile width (csrc/u8_tile.cuh
        # BN, wgmma's N) — compiled into the sources
    }),
    "backends/torch_dense.py": frozenset({
        "_RECT_TILE_ROWS",  # rect streaming row tile (HBM-budget halver)
    }),
    "serving/buckets.py": frozenset({
        "DEFAULT_BUCKETS",  # serve_buckets 'pow2' default, documented
    }),
    "ops/planner.py": frozenset({
        "_DEG_BUCKETS",   # degree-histogram resolution (24 log2 buckets
        # cover any int32 index space) — an audit-layout invariant of
        # FactorStats, not a measured performance choice; the planner's
        # real knobs (plan_density_cutover, plan_dp_max_len,
        # plan_memo_budget_mb) are registry knobs above
    }),
    "ops/packed.py": frozenset({
        "_PACK_CHUNK_ROWS",    # delta re-encode / tile-alignment chunk
        # granularity — consumers pass their own tile width; this is
        # the standalone default, a layout invariant
        "_BLOCK_NNZ",          # bit-packing width-adaptation block size
        # (each block stores its own bit width) — layout invariant of
        # the bitpacked stream, not a measured perf choice
        "_PACK_BUCKET_FLOOR",  # pow-2 chunk-buffer capacity floor: the
        # realloc-stability contract (delta-drifted nnz stays inside
        # one bucket), analogous to sparse_nnz_floor's role but for
        # host buffers; the measured knob is factor_format above
    }),
    "obs/metrics.py": frozenset({
        "DEFAULT_BUCKETS_PER_DECADE",  # histogram resolution (quantile
        # rel-err bound is derived from it in tests) — an accuracy
        # layout invariant, not a measured performance choice
    }),
    "serving/service.py": frozenset({
        "tile_cache_bytes",  # ServeConfig capacity defaults: operator-
        "tile_rows",         # facing CLI config (cache budget/eviction
                             # granularity), not measured kernel knobs
    }),
}
