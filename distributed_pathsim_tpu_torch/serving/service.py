"""PathSimService: a warm, coalescing, caching online query frontend.

Construction does the expensive work ONCE — the backend's half factor
is assembled and left resident on the card, the denominator vector is
prefetched to host f64, and every serving shape bucket is driven once
(``utils.compile_counter.warm_compile_cache``) — and then queries flow
through three tiers:

1. result LRU (cache.py) — repeated (row, k) queries are a dict lookup;
2. hot-tile score cache — a known score row re-selects top-k on host
   for any k, no dispatch;
3. coalesced batched dispatch (coalescer.py) — misses from concurrent
   clients are padded into power-of-two buckets and served by ONE
   batched gather + GEMM, double-buffered so bucket N+1's GEMM overlaps
   bucket N's host transfer (the GEMM on the backend's serving stream,
   the copy on another; see ``backends/torch_dense.PendingRows``).

Served results are bit-identical to the offline driver's ``top_k``:
both route through the backend's batched row counts (exact integer
counts in f32 below the 2^24 guard, any summation order), f64
normalization on the host and the (descending score, ascending column)
tie order — verified by test, padding and batching included.

Beside the primary metapath, a request may name another closed metapath
(``metapath=``): it is answered by a lazily built :class:`MetapathEngine`
on its own coalescer lane, every engine folding through one shared
workload-level sub-chain memo (``ops/planner.SubchainCache``). Background
compaction (``serving/compact.py``) re-encodes the graph with fresh
capacity headroom off the serving path and hot-swaps it with the
consistency token and both cache tiers intact.

``mode="ann"`` (or ``--topk-mode ann``) answers through the centroid
MIPS index (index/, serving/ann.py): the probe runs on the index's
device, the candidates are reranked exactly in host f64, and a row the
index cannot vouch for (stale, appended, degenerate, confidence lost,
no index) answers through the exact lane, counted by reason. Whenever
the candidates cover the exact top-k the ANN answer is bit-identical to
the exact one.

``mode="learned"`` (or ``--topk-mode learned``) answers through the
two-tower candidates of a tower checkpoint (learned/): the tower probe
and the top-C pick run on the backend's device, the candidates are
reranked exactly in host f64, and a row the towers cannot vouch for
(stale, degenerate, confidence lost, another metapath, no towers)
degrades learned → ann → exact, counted by reason. ``refresh_towers``
re-embeds the delta-touched and appended rows through the inductive
encoder (cold start). A learned-mode service without a usable
checkpoint distills its own towers at install, on the backend's device
(``learned_ready`` with ``source="trained"``).

The port serves the exact, ANN and learned lanes of the JAX package's
service, and the batch tier's ``batch_blocks`` op.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from ..backends.base import PathSimBackend
from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..ops import pathsim
from ..ops import planner
from ..utils.compile_counter import (
    compiles_total,
    install_compile_metrics,
    warm_compile_cache,
)
from ..utils.logging import runtime_event
from .buckets import resolve_ladder
from .cache import HotTileCache, ResultCache, graph_fingerprint
from .coalescer import BatchStats, Coalescer, Request

# Lane prefix of secondary-metapath dispatches: the coalescer never
# mixes lanes in one batch, so each metapath's queries pad into their
# own batched GEMM against that metapath's engine.
_MP_LANE = "mp:"

# The compaction-swap doorway surface: these internals perform the
# token-preserving hot-swap and are only sound inside _apply_compaction
# under the swap lock with the mid-build replay log in hand.
# serving/compact.py is the one sanctioned caller; everything else
# compacts via service.compact() or the 'compact' protocol op.
COMPACTION_SURFACE = frozenset({
    "_apply_compaction",
    "_swap_compacted",
})


@dataclasses.dataclass
class MetapathEngine:
    """One lazily-built secondary-metapath serving engine: a warm
    backend for a non-default metapath, sharing the service's
    sub-chain memo, caches, and coalescer. ``fallback_from`` records a
    backend-class degrade (an asymmetric chain that torch-sparse
    refuses, served by ``torch`` on the card or ``numpy`` on the host)
    — results are bit-identical either way."""

    metapath: object
    backend: PathSimBackend
    d: np.ndarray  # f64 denominators, prefetched like the primary's
    n: int
    fallback_from: str | None = None


@dataclasses.dataclass
class ServeConfig:
    """Serving knobs (all CLI-exposed via the ``serve`` subcommand)."""

    max_batch: int = 32
    max_wait_ms: float = 2.0
    queue_depth: int = 256
    cache_entries: int = 4096        # tier-1 result LRU capacity
    tile_cache_bytes: int = 64 << 20  # tier-2 hot-tile budget
    tile_rows: int = 64               # tier-2 eviction granularity
    k_default: int = 10
    warm: bool = True                 # drive every bucket at startup
    request_timeout_s: float = 60.0
    batch_events: bool = False        # per-batch JSONL events
    # Delta ingestion: a batch changing more than this fraction of the
    # graph's edges (or exhausting index headroom) rebuilds instead of
    # patching — past it the O(Δ) machinery converges on rebuild cost.
    delta_threshold: float = 0.05
    # -- multi-metapath workload ---------------------------------------
    # Sub-chain memo budget shared by every metapath engine (None →
    # the tuned ``plan_memo_budget_mb`` knob; 0 disables memoization).
    memo_budget_mb: float | None = None
    # Bound on lazily-built secondary metapath engines: each holds a
    # warm backend (a device factor), so the set must not grow with
    # request fields.
    max_metapaths: int = 8
    # -- background compaction (serving/compact.py) --------------------
    # Re-encode with fresh pow-2 headroom and hot-swap in the
    # background when the capacity reserve runs low or the delta chain
    # grows long — the firehose alternative to the synchronous
    # headroom-exhausted rebuild. The swap preserves the consistency
    # token and both cache tiers (the logical graph is unchanged).
    compact_auto: bool = True
    # deltas absorbed since the last re-encode before a chain-triggered
    # compaction (None → the tuned ``compact_chain_len`` knob)
    compact_chain_len: int | None = None
    # trigger when min type headroom falls below this fraction of the
    # logical size (only for types that reserved capacity at build)
    compact_headroom_frac: float = 0.10
    # fresh capacity reserve of the re-encode (None → the tuned
    # ``compact_headroom`` knob); padded to pow-2 buckets either way
    compact_headroom: float | None = None
    compact_cooldown_s: float = 5.0
    # bounded build retries when deltas keep landing mid-build
    compact_attempts: int = 3
    # -- ANN candidate generation (index/, serving/ann.py) -------------
    # Default answer path: "exact" scores the full O(N) row; "ann"
    # probes the MIPS index for C ≫ k candidates and exact-reranks
    # them; "learned" shortlists through the two-tower encoder and
    # exact-reranks (per-request override via submit_topk's ``mode``).
    topk_mode: str = "exact"
    # Prebuilt `dpathsim-torch index build` artifact; None + mode "ann"
    # builds the struct-embedded index in-process at startup.
    index_path: str | None = None
    # Probe geometry; None resolves through the tuning registry
    # (ann_nprobe / ann_cand_mult / ann_centroids / ann_cluster_cap /
    # ann_probe_variant) with the documented heuristics as defaults.
    ann_nprobe: int | None = None
    ann_cand_mult: int | None = None
    ann_centroids: int | None = None
    ann_cluster_cap: int | None = None
    ann_variant: str | None = None   # rerank-all | shortlist
    # Shadow-recall confidence gate: every Nth ann dispatch also runs the
    # exact oracle and folds recall@k into dpathsim_ann_recall_ratio;
    # below the floor (after min_shadow samples) ann disables itself
    # until the next refresh (0 disables shadowing).
    ann_shadow_every: int = 64
    ann_recall_floor: float = 0.98
    ann_min_shadow: int = 8
    # Background re-embed of delta-staled index rows (a daemon thread
    # per delta burst, debounced); off = refresh only via the
    # refresh_index op/method.
    ann_auto_refresh: bool = True
    # -- learned candidate generation (learned/) -----------------------
    # A `dpathsim-torch learned train` (or the JAX package's `dpathsim
    # learned train`) tower artifact; None + mode "learned" distills a
    # tower in-process at install (exact-teacher mining).
    learned_checkpoint: str | None = None
    # In-process training geometry (None resolves the tuned
    # learned_dim / learned_neg_ratio knobs); steps stay small — the
    # exact rerank carries correctness, the tower only needs recall.
    learned_dim: int | None = None
    learned_steps: int = 200
    learned_neg_ratio: float | None = None
    # candidates per learned query as a multiple of k (None → the
    # tuned learned_cand_mult knob)
    learned_cand_mult: int | None = None
    # Shadow-recall confidence gate (the ann gate's twin): every Nth
    # learned dispatch also runs the exact oracle; measured
    # score-recall below the floor disables the learned arm until a
    # refresh. None floor → the tuned learned_conf_floor knob.
    learned_shadow_every: int = 64
    learned_recall_floor: float | None = None
    learned_min_shadow: int = 8
    # Re-embed delta-staled/appended rows in a background thread after
    # patch updates (stale/cold rows answer by counted fallback in the
    # meantime); cadence (every Nth delta) is the tuned
    # learned_refresh_deltas knob.
    learned_auto_refresh: bool = True


class PathSimService:
    """Holds one warm backend and serves single-source top-k / score
    queries against it, coalescing concurrent requests."""

    def __init__(
        self,
        backend: PathSimBackend,
        variant: str = "rowsum",
        config: ServeConfig | None = None,
        backend_factory=None,
    ):
        self.config = config or ServeConfig()
        self.variant = variant
        self._swap_lock = threading.Lock()  # serializes reload vs admit
        self.result_cache = ResultCache(self.config.cache_entries)
        self.tile_cache = HotTileCache(
            self.config.tile_cache_bytes, tile_rows=self.config.tile_rows
        )
        self._bucket_hist: dict[int, int] = {}
        self._wait_ms_sum = 0.0
        # update()'s full-rebuild fallback (and compaction) needs a
        # fresh backend for a new encoding. The default rebuilds with the
        # incumbent's class and pass-through options, the sub-chain memo
        # threaded in so a refold hits the still-valid entries;
        # build_service installs a factory that replays the full
        # RunConfig knobs.
        self._backend_factory = backend_factory or (
            lambda hin: type(self.backend)(
                hin, self.metapath,
                **{**self.backend.options, "subchain_memo": self.memo},
            )
        )
        self._update_stats = {"deltas": 0, "rebuilds": 0, "purged_rows": 0}
        # obs handles, bound once per service (hot-path discipline: a
        # request pays cell increments, never registry lookups)
        reg = get_registry()
        self._m_latency = {
            outcome: reg.histogram(
                "dpathsim_serve_request_seconds",
                "submit-to-resolve request latency by outcome",
            ).labels(outcome=outcome)
            for outcome in (
                "hit_result", "hit_tile", "dispatch", "ann", "learned"
            )
        }
        self._m_updates = reg.counter(
            "dpathsim_serve_updates_total",
            "delta-update outcomes (patch vs rebuild)",
        )
        # compiles visible live: a steady-state serving process whose
        # counter moves is violating the shape-bucket contract
        install_compile_metrics()
        self._resolve_mode(None)  # the default mode: refused up front
        self._ann = None  # AnnState once _setup_ann builds/loads one
        self._ann_refresh_inflight = False  # background-refresh debounce
        self._learned = None  # LearnedState once _setup_learned loads one
        self._learned_refresh_inflight = False
        self._learned_deltas = 0  # deltas since the last tower refresh
        self._learned_refresh_every = 1  # tuned cadence (re-set at setup)
        # Workload-level sub-chain memo + lazily-built per-metapath
        # engines (per-request ``metapath`` field). Built BEFORE the
        # backend install so a rebuild-time engine flush finds them.
        n0 = backend.hin.type_size(backend.metapath.source_type)
        budget = (
            planner.default_memo_budget_bytes(n0)
            if self.config.memo_budget_mb is None
            else int(self.config.memo_budget_mb * (1 << 20))
        )
        memo_fmt = (backend.factor_info() or {}).get("format", "coo")
        self.memo = (
            planner.SubchainCache(budget, factor_format=memo_fmt)
            if budget > 0 else None
        )
        # _engines is read on coalescer threads mid-dispatch, where
        # taking _swap_lock would deadlock against update()'s
        # hold-and-drain — so the dict gets its own LEAF lock (never
        # held across another acquisition; builds still serialize
        # under _swap_lock, only the dict ops take this one).
        self._engines_lock = threading.Lock()
        self._engines: dict[str, MetapathEngine] = {}
        self._m_engines = reg.counter(
            "dpathsim_plan_engines_total",
            "secondary metapath engines built, by metapath",
        )
        self._install_backend(backend, warm=self.config.warm)
        # background compaction: triggered per absorbed delta under
        # _swap_lock; built AFTER the first install so its tuned
        # thresholds see the real n
        from .compact import Compactor

        self._compactor = Compactor(self)
        self.coalescer = Coalescer(
            issue=self._issue,
            complete=self._complete,
            max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms,
            queue_depth=self.config.queue_depth,
            on_batch=self._record_batch,
            bucket_ladder=self._bucket_ladder,
        )

    # -- warm state --------------------------------------------------------

    def _install_backend(self, backend: PathSimBackend, warm: bool) -> None:
        """Make a backend serving-warm: denominators prefetched (for the
        torch backend this also assembles C and leaves it resident on
        the card), fingerprint computed, buckets driven once. The
        denominators come first: a graph past the backend's exactness
        guard raises here, before the service's state is touched."""
        d = np.asarray(backend._denominators(self.variant), dtype=np.float64)
        # a wholesale install re-bases the consistency token: the
        # compaction chain restarts and any in-flight build is stale
        # (absent only during the constructor's first install)
        compactor = getattr(self, "_compactor", None)
        if compactor is not None:
            compactor.note_rebuild()
        self.backend = backend
        self.hin = backend.hin
        self.metapath = backend.metapath
        # Secondary engines bind the OLD hin/backend generation: drop
        # them (they rebuild lazily against the new graph, re-hitting
        # the sub-chain memo for factors whose content didn't change).
        with self._engines_lock:
            self._engines.clear()
        self.node_type = backend.metapath.source_type
        self.index = self.hin.indices[self.node_type]
        self.n = self.index.size
        self._base_fp = graph_fingerprint(self.hin)
        self._fp = self._base_fp
        self._delta_seq = 0
        # Per-row cache versions (sized to CAPACITY so node appends have
        # slots): a delta update bumps only the rows it affects, so
        # entries for every other row stay reachable — the row-granular
        # alternative to flushing both tiers. The (base_fp, version) key
        # pair can never resurrect a stale answer: versions only grow,
        # and a rebuild/reload swaps base_fp itself.
        self._row_ver = np.zeros(self.index.padded_size, dtype=np.int64)
        self._d = d
        # Bucket geometry through the tuning registry (untuned: the
        # pow2 ladder). The SAME ladder feeds warmup and the coalescer —
        # a mismatch would dispatch a bucket warmup never drove.
        from .. import tuning

        geometry = tuning.choose(
            "serve_buckets", n=self.n, v=self.config.max_batch,
            default="pow2",
        )
        if geometry not in tuning.KNOBS["serve_buckets"].candidates(
            {"n": self.n}
        ):
            # unknown geometry from a stale table: heuristics, loudly
            runtime_event("tuning_bad_choice", knob="serve_buckets",
                          choice=geometry)
            geometry = "pow2"
        self._bucket_ladder = resolve_ladder(geometry, self.config.max_batch)
        coal = getattr(self, "coalescer", None)
        if coal is not None:
            coal.buckets = self._bucket_ladder
        if warm:
            warm_compile_cache(
                backend,
                self._bucket_ladder,
                k=self.config.k_default,
                variant=self.variant,
            )
        self._setup_ann(warm=warm)
        self._setup_learned(warm=warm)

    def _setup_ann(self, warm: bool) -> None:
        """(Re)build or load the ANN candidate index for the freshly
        installed backend. Every defect degrades to exact serving with
        a loud event, never a crash — exact is the ground truth, so
        losing the index only loses the speedup. The index probes on
        the backend's device (the host for the numpy oracle)."""
        cfg = self.config
        if self._ann is not None:
            # a reload/rebuild replaces the state: release the old
            # rerank pool (and drop its C/blocks snapshots) instead of
            # leaking one executor per swap
            self._ann.close()
        self._ann = None
        if cfg.topk_mode != "ann" and cfg.index_path is None:
            return
        from .. import tuning
        from ..index import CentroidIndex, IndexMismatch, build_index
        from ..index.build import half_chain_and_denominators
        from .ann import AnnState

        t0 = time.perf_counter()
        device = getattr(self.backend, "device", None) or "cpu"
        try:
            c, d = half_chain_and_denominators(
                self.hin, self.metapath, self.variant
            )
        except (ValueError, MemoryError) as exc:
            runtime_event("ann_unavailable", reason=str(exc))
            return
        if cfg.index_path is not None:
            try:
                index = CentroidIndex.load(
                    cfg.index_path, expect_base_fp=self._base_fp,
                    device=device,
                )
            except (IndexMismatch, OSError, KeyError, ValueError) as exc:
                runtime_event(
                    "ann_index_rejected", path=cfg.index_path,
                    reason=str(exc),
                )
                return
            if tuple(index.token) != self.consistency_token:
                # an artifact persisted mid-delta-stream: its rows may
                # lag this replica's graph — refuse rather than serve
                # candidates from an unverifiable epoch
                runtime_event(
                    "ann_index_rejected", path=cfg.index_path,
                    reason=f"index token {index.token} != service "
                    f"token {self.consistency_token}",
                )
                return
            # the fingerprint pins the GRAPH; the embedding geometry
            # must also match the served score function — candidates
            # from a different variant/metapath would silently degrade
            # recall while the exact rerank hides the mismatch
            for axis, want in (("variant", self.variant),
                               ("metapath", self.metapath.name)):
                got = index.meta.get(axis)
                if got is not None and got != want:
                    runtime_event(
                        "ann_index_rejected", path=cfg.index_path,
                        reason=f"index {axis} {got!r} != served "
                        f"{want!r}",
                    )
                    return
        else:
            index = build_index(
                c=c, d=d, variant=self.variant, metapath=self.metapath,
                n_centroids=cfg.ann_centroids,
                cluster_cap=cfg.ann_cluster_cap,
                token=self.consistency_token, device=device,
            )
        # scale-aware nprobe heuristic: K/3 clamped to [16, 96], the JAX
        # package's recall-safe point for maps narrower than max_dim; a
        # measured table trades it per box. Past max_dim the index's JL
        # projection costs recall that nprobe does not buy back
        # (PERF.md, the ANN tier)
        nprobe = cfg.ann_nprobe or tuning.choose(
            "ann_nprobe", n=self.n,
            default=min(max(16, index.n_centroids // 3), 96),
        )
        cand_mult = cfg.ann_cand_mult or tuning.choose(
            "ann_cand_mult", n=self.n, default=16
        )
        variant = cfg.ann_variant or tuning.choose(
            "ann_probe_variant", n=self.n, default="rerank-all"
        )
        self._ann = AnnState(
            index, c, d,
            nprobe=int(nprobe), cand_mult=int(cand_mult),
            variant=str(variant),
            shadow_every=cfg.ann_shadow_every,
            recall_floor=cfg.ann_recall_floor,
            min_shadow=cfg.ann_min_shadow,
        )
        if warm and not (
            self._ann.variant == "rerank-all" and self._ann.route_on_host
        ):
            # the ANN analog of the bucket warmup: the probe driven once
            # per serving bucket (host routing has nothing to warm)
            index.warm(self._bucket_ladder, self._ann.nprobe,
                       variant=self._ann.variant)
        runtime_event(
            "ann_ready",
            n=index.n, centroids=index.n_centroids,
            cluster_cap=index.cluster_cap, dim=index.dim,
            nprobe=self._ann.nprobe, cand_mult=self._ann.cand_mult,
            variant=self._ann.variant,
            source="file" if cfg.index_path else "built",
            startup_s=round(time.perf_counter() - t0, 3),
        )

    def _setup_learned(self, warm: bool) -> None:
        """(Re)build the learned-tower candidate state for the freshly
        installed backend. A ``learned_checkpoint`` must be keyed to this
        graph and token and to the served variant and metapath; an
        unusable one on a service where the learned arm is optional
        degrades quietly (``learned_towers_rejected``). A learned-mode
        service with no usable checkpoint — at startup, or at a later
        install whose graph the towers no longer match — distills its
        own towers in-process on the backend's device (exact-teacher
        mining + ``learned_steps`` steps), as the JAX package's does.
        The towers embed the corpus on the backend's device (the host
        for the numpy oracle)."""
        cfg = self.config
        if self._learned is not None:
            self._learned.close()
        self._learned = None
        if cfg.topk_mode != "learned" and cfg.learned_checkpoint is None:
            return
        from .. import tuning
        from ..index.build import half_chain_and_denominators
        from ..learned import (
            LearnedState,
            TowerMismatch,
            load_towers,
            train_towers,
        )

        t0 = time.perf_counter()
        device = getattr(self.backend, "device", None) or "cpu"
        try:
            c, d = half_chain_and_denominators(
                self.hin, self.metapath, self.variant
            )
        except (ValueError, MemoryError) as exc:
            runtime_event("learned_unavailable", reason=str(exc))
            return
        encoder = token = None
        source = "file"
        if cfg.learned_checkpoint is not None:
            reason = None
            try:
                encoder, token = load_towers(
                    cfg.learned_checkpoint, expect_base_fp=self._base_fp
                )
            except (TowerMismatch, OSError, KeyError, ValueError) as exc:
                reason = str(exc)
            if encoder is not None and tuple(token) != self.consistency_token:
                # an artifact trained mid-delta-stream: its towers may
                # lag this replica's graph — refuse rather than serve
                # candidates from an unverifiable epoch
                reason = (f"towers token {list(token)} != service "
                          f"token {self.consistency_token}")
                encoder = None
            if encoder is not None:
                for axis, want in (("variant", self.variant),
                                   ("metapath", self.metapath.name)):
                    got = getattr(encoder, axis)
                    if got != want:
                        reason = f"towers {axis} {got!r} != served {want!r}"
                        encoder = None
                        break
            if encoder is None:
                runtime_event(
                    "learned_towers_rejected",
                    path=cfg.learned_checkpoint, reason=reason,
                )
                if cfg.topk_mode != "learned":
                    # the learned arm was optional here — degrade quietly
                    return
        if encoder is None:
            # no checkpoint, or a rejected one on a learned-mode service:
            # distill in-process (the rejection already shouted; a
            # learned-mode replica must still come up serving learned)
            dim = cfg.learned_dim or int(tuning.choose(
                "learned_dim", n=self.n, default=32
            ))
            neg_ratio = (
                cfg.learned_neg_ratio
                if cfg.learned_neg_ratio is not None
                else float(tuning.choose(
                    "learned_neg_ratio", n=self.n, default=0.5
                ))
            )
            try:
                encoder, _ = train_towers(
                    self.hin, self.metapath, variant=self.variant,
                    dim=dim, steps=cfg.learned_steps,
                    hard_frac=1.0 - neg_ratio,
                    hard_sources=min(self.n, 512),
                    token=self.consistency_token,
                    device=device,
                )
            except (ValueError, MemoryError) as exc:
                runtime_event("learned_unavailable", reason=str(exc))
                return
            token = self.consistency_token
            source = "trained"
        cand_mult = cfg.learned_cand_mult or int(tuning.choose(
            "learned_cand_mult", n=self.n, default=16
        ))
        recall_floor = (
            cfg.learned_recall_floor
            if cfg.learned_recall_floor is not None
            else float(tuning.choose(
                "learned_conf_floor", n=self.n, default=0.98
            ))
        )
        self._learned = LearnedState(
            encoder, c, d,
            cand_mult=cand_mult,
            shadow_every=cfg.learned_shadow_every,
            recall_floor=recall_floor,
            min_shadow=cfg.learned_min_shadow,
            token=token,
            device=device,
        )
        if warm:
            # the probe driven once per serving bucket, so the first
            # request of each pays no device set-up
            self._learned.warm(self._bucket_ladder, cfg.k_default)
        self._learned_deltas = 0
        self._learned_refresh_every = max(int(tuning.choose(
            "learned_refresh_deltas", n=self.n, default=1
        )), 1)
        runtime_event(
            "learned_ready",
            n=self._learned.n, dim=encoder.dim, hidden=encoder.hidden,
            cand_mult=cand_mult, recall_floor=recall_floor,
            source=source,
            startup_s=round(time.perf_counter() - t0, 3),
        )

    def _epoch_for(self, row: int) -> tuple:
        """Cache-identity prefix for one source row: install-time base
        fingerprint + this row's delta version (+ the query identity
        axes). Versioned per ROW, not per graph — that is what lets a
        delta keep unaffected rows' entries live."""
        return (
            self._base_fp,
            self.metapath.name,
            self.variant,
            int(self._row_ver[row]),
        )

    # -- secondary metapath engines (per-request ``metapath`` field) -------

    def _canon_metapath(self, metapath: str | None) -> str:
        """Per-request metapath name → canonical name (None → the
        service default). Cheap; full validation happens at engine
        build."""
        if metapath is None:
            return self.metapath.name
        name = str(metapath).strip()
        if not name:
            return self.metapath.name
        return name

    def _mp_epoch(self, name: str) -> tuple:
        """Cache-identity prefix of a secondary metapath's entries:
        the CHAINED fingerprint (not the base) — any delta advances it,
        so secondary answers invalidate wholesale per delta while the
        primary keeps its row-granular story. Coarse but sound: the
        affected-row analysis is derived per half-chain, and secondary
        engines rebuild lazily anyway."""
        return (self._fp, name, self.variant)

    def _engine_for(self, name: str) -> MetapathEngine:
        """Get or lazily build the serving engine for a non-default
        metapath. Caller holds ``_swap_lock`` (engine builds must not
        interleave with a backend swap) — so a FIRST build of a new
        metapath blocks admissions for its backend init + warmup, the
        same stall discipline a reload already has. The engine shares
        the service's sub-chain memo, so concurrent metapath lanes share
        common sub-chain folds (APVPA/APA/APTPA all reuse the A·P
        factor). An engine whose chain trips the exact-count guard
        raises to its request and is never kept."""
        with self._engines_lock:
            eng = self._engines.get(name)
            n_engines = len(self._engines)
        if eng is not None:
            return eng
        if n_engines >= self.config.max_metapaths:
            raise ValueError(
                f"metapath engine limit ({self.config.max_metapaths}) "
                "reached; raise --max-metapaths or restart with the "
                "needed default"
            )
        from ..backends.base import create_backend
        from ..ops.metapath import compile_metapath
        from ..resilience.degrade import engine_fallback

        t0 = time.perf_counter()
        mp = compile_metapath(name, self.hin.schema)
        if mp.source_type != mp.target_type:
            raise ValueError(
                f"metapath {name!r} is not closed "
                f"({mp.source_type!r} → {mp.target_type!r}); serving "
                "scores rows of the source type against itself, so a "
                "served metapath must start and end on one type"
            )
        options = dict(self.backend.options)
        options["subchain_memo"] = self.memo
        fallback_from = None
        try:
            backend = create_backend(
                self.backend.name, self.hin, mp, **options
            )
        except ValueError as exc:
            # e.g. an asymmetric-but-closed chain on torch-sparse:
            # degrade THIS engine only — bit-identical results. Work
            # asked for on the card stays there (torch), the host steps
            # down to the numpy oracle as the JAX service does.
            device = getattr(self.backend, "device", None)
            step = engine_fallback(
                self.backend.name, options,
                "cpu" if device is None else device.type,
            )
            if step is None:
                raise
            to, opts = step
            fallback_from = self.backend.name
            runtime_event(
                "metapath_engine_fallback", metapath=name,
                from_=self.backend.name, to=to, reason=str(exc),
            )
            backend = create_backend(to, self.hin, mp, **opts)
        # the exactness guard first: a chain past it raises here,
        # before the engine is kept or warmed
        d = np.asarray(backend._denominators(self.variant), dtype=np.float64)
        if self.config.warm:
            warm_compile_cache(
                backend, self._bucket_ladder,
                k=self.config.k_default, variant=self.variant,
            )
        eng = MetapathEngine(
            metapath=mp, backend=backend, d=d, n=backend.n_sources,
            fallback_from=fallback_from,
        )
        with self._engines_lock:
            self._engines[name] = eng
        self._m_engines.inc(metapath=name)
        runtime_event(
            "metapath_engine_ready",
            metapath=name, backend=backend.name, n=eng.n,
            order=backend.plan.order(),
            est_flops=round(float(backend.plan.est_flops), 1),
            startup_s=round(time.perf_counter() - t0, 3),
        )
        return eng

    # -- dispatch plumbing (runs on coalescer threads) ---------------------

    @staticmethod
    def _issue_on(backend: PathSimBackend, rows_padded: np.ndarray):
        """The torch backend returns a handle on a GEMM queued on its
        serving stream (the double buffer overlaps the host copy with
        the next bucket's GEMM); others return host counts directly."""
        issue_device = getattr(backend, "pairwise_rows_device", None)
        if issue_device is not None:
            handle = issue_device(rows_padded)
            if handle is not None:
                return handle
        return backend.pairwise_rows(rows_padded)

    def _issue(self, rows_padded: np.ndarray, k: int, lane: str = "exact"):
        """Dispatcher-thread half of a batch: returns the in-flight
        counts handle. A secondary-metapath lane issues against its
        engine (present by construction — submit built it under the
        swap lock, and update/reload/compaction drain the pipeline
        before dropping engines). The ``ann`` lane issues the index
        probe instead — one batched matmul over the packed cluster
        blocks (or the route alone), fetched by the completion half the
        way the exact lane's rows are (``PendingRows``). The ``learned``
        lane issues the tower probe and the top-C pick on the towers'
        device, fetched the same way."""
        if lane == "learned":
            return self._learned.probe_batch(rows_padded, k)
        if lane == "ann":
            return self._ann.issue(rows_padded)
        if lane.startswith(_MP_LANE):
            with self._engines_lock:
                eng = self._engines[lane[len(_MP_LANE):]]
            return self._issue_on(eng.backend, rows_padded)
        return self._issue_on(self.backend, rows_padded)

    def _complete(
        self,
        handle,
        rows: np.ndarray,
        batch: Sequence[Request],
        k: int,
        lane: str = "exact",
    ) -> None:
        """Completion-thread half: fetch counts, normalize in f64, top-k
        per request (each gets the k-prefix it asked for), fill both
        cache tiers, resolve futures. A secondary-metapath lane runs the
        same arithmetic against its engine's counts and denominators
        under the metapath's own cache epoch. The tracer spans opened
        here parent into the batch's ``serve.complete`` span — the
        coalescer activated its context on this thread before calling."""
        if lane == "learned":
            return self._complete_learned(handle, rows, batch)
        if lane == "ann":
            return self._complete_ann(handle, rows, batch)
        span_args = {}
        if lane.startswith(_MP_LANE):
            name = lane[len(_MP_LANE):]
            with self._engines_lock:
                eng = self._engines[name]
            n, d, mp_epoch = eng.n, eng.d, self._mp_epoch(name)
            epoch_of = lambda row: mp_epoch  # noqa: E731
            span_args["metapath"] = name
        else:
            n, d, epoch_of = self.n, self._d, self._epoch_for
        tracer = get_tracer()
        with tracer.child_span("serve.host_transfer", n=int(rows.shape[0]),
                               **span_args):
            # column trim to the logical width: handles from a
            # capacity-padded backend carry zero-count pad columns.
            # np.asarray is where a device handle actually blocks — the
            # transfer segment of the trace.
            counts = np.asarray(handle, dtype=np.float64)[
                : rows.shape[0], : n
            ]
        scores = pathsim.score_rows(counts, d[rows], d, xp=np)
        masked = scores.copy()
        masked[np.arange(rows.shape[0]), rows] = -np.inf
        k_eff = min(k, max(n - 1, 1))
        vals, idxs = pathsim.topk_from_score_rows(masked, k_eff)
        with tracer.child_span("serve.cache_fill", n=len(batch)):
            for b, req in enumerate(batch):
                epoch = epoch_of(int(rows[b]))
                # copy, not a view: a cached view would pin the whole
                # [B, N] batch array long past the byte budget's
                # accounting
                self.tile_cache.put_row(
                    epoch, int(rows[b]), scores[b].copy()
                )
                kr = min(req.k, k_eff)
                rv, ri = vals[b, :kr], idxs[b, :kr]
                self.result_cache.put(
                    (*epoch, int(rows[b]), req.k), rv, ri
                )
                if not req.future.done():
                    req.future.set_result((rv, ri))
                # observed AFTER the future resolves, from the
                # SUBMITTER's clock reading: the histogram's claim is
                # submit-to-resolve, so cache-fill time and swap-lock
                # wait must be inside it, not carved out
                self._m_latency["dispatch"].observe(
                    time.monotonic() - (req.t_submit or req.t_enqueue)
                )
                tracer.finish(req.span, outcome="dispatch")

    def _complete_ann(
        self, handle, rows: np.ndarray, batch: Sequence[Request]
    ) -> None:
        """Completion half of an ``ann`` batch: fetch the probe's
        output, select each request's C = cand_mult·k candidates on
        the host, exact-f64-rerank them against the C/d snapshot, fill
        the ann result-cache tier, resolve futures. Every Nth dispatch
        also runs the exact oracle for its row (shadow sampling) to
        keep the recall-confidence gate honest."""
        tracer = get_tracer()
        ann = self._ann
        t0 = time.perf_counter()
        with tracer.child_span(
            "serve.ann_probe_transfer", n=int(rows.shape[0])
        ):
            first = np.asarray(handle[0])
            second = np.asarray(handle[1])
        ann.observe_probe(time.perf_counter() - t0)

        def _rerank_one(b: int):
            row = int(rows[b])
            k_eff = min(batch[b].k, max(self.n - 1, 1))
            t1 = time.perf_counter()
            if ann.variant == "rerank-all":
                # (mem, top_c): exact-rerank every probed member
                vals, idxs = ann.rerank_all(
                    row, first[b], second[b], k_eff, self.n
                )
            else:
                # (sims, mem): approximate shortlist → exact rerank
                cand = ann.candidates_for(
                    first[b], second[b], k_eff, self.n
                )
                vals, idxs = ann.rerank(row, cand, k_eff)
            ann.observe_rerank(time.perf_counter() - t1)
            return k_eff, vals, idxs

        with tracer.child_span("serve.ann_rerank", n=len(batch)):
            # per-request reranks are independent: fan them over the
            # ann pool (numpy/BLAS release the GIL), resolve in order
            reranked = list(ann.pool.map(_rerank_one, range(len(batch))))
            shadows = []
            for b, req in enumerate(batch):
                row = int(rows[b])
                k_eff, vals, idxs = reranked[b]
                ann.count_answered()
                if ann.should_shadow():
                    # deferred: the O(N) oracle scan must never sit in
                    # front of a waiting future — the sampled request's
                    # (and the rest of the batch's) latency is exactly
                    # what the ANN path exists to shrink
                    shadows.append((row, k_eff, vals))
                self.result_cache.put(self._ann_key(row, req.k), vals, idxs)
                if not req.future.done():
                    req.future.set_result((vals, idxs))
                self._m_latency["ann"].observe(
                    time.monotonic() - (req.t_submit or req.t_enqueue)
                )
                tracer.finish(req.span, outcome="ann")
            for row, k_eff, vals in shadows:  # every future resolved
                evals, _ = self.backend.topk_row(
                    row, k=k_eff, variant=self.variant
                )
                ann.record_shadow(vals, evals, k_eff)

    def _complete_learned(
        self, handle, rows: np.ndarray, batch: Sequence[Request]
    ) -> None:
        """Completion half of a ``learned`` batch: fetch the probe's
        candidate ids, exact-f64 rerank each request's shortlist INSIDE
        learned/ (this method never sees a raw similarity), fill the
        learned result-cache tier, resolve futures. Every Nth dispatch
        also runs the exact oracle (shadow sampling) to keep the
        recall-confidence gate honest — deferred past future resolution
        like the ANN path, because an O(N) oracle scan must never sit in
        front of a waiting caller."""
        tracer = get_tracer()
        lr = self._learned
        t0 = time.perf_counter()
        with tracer.child_span(
            "serve.learned_probe_transfer", n=int(rows.shape[0])
        ):
            handle.fetch()
        lr.observe_probe(time.perf_counter() - t0)

        def _rerank_one(b: int):
            row = int(rows[b])
            k_eff = min(batch[b].k, max(self.n - 1, 1))
            t1 = time.perf_counter()
            vals, idxs = lr.answer_from_handle(handle, b, row, k_eff)
            lr.observe_rerank(time.perf_counter() - t1)
            return k_eff, vals, idxs

        with tracer.child_span("serve.learned_rerank", n=len(batch)):
            reranked = list(lr.pool.map(_rerank_one, range(len(batch))))
            shadows = []
            for b, req in enumerate(batch):
                row = int(rows[b])
                k_eff, vals, idxs = reranked[b]
                lr.count_answered()
                if lr.should_shadow():
                    shadows.append((row, k_eff, vals))
                self.result_cache.put(
                    self._learned_key(row, req.k), vals, idxs
                )
                if not req.future.done():
                    req.future.set_result((vals, idxs))
                self._m_latency["learned"].observe(
                    time.monotonic() - (req.t_submit or req.t_enqueue)
                )
                tracer.finish(req.span, outcome="learned")
            for row, k_eff, vals in shadows:  # every future resolved
                evals, _ = self.backend.topk_row(
                    row, k=k_eff, variant=self.variant
                )
                lr.record_shadow(vals, evals, k_eff)

    def _record_batch(self, stats: BatchStats) -> None:
        self._bucket_hist[stats.bucket] = (
            self._bucket_hist.get(stats.bucket, 0) + 1
        )
        self._wait_ms_sum += stats.wait_ms
        if self.config.batch_events:
            runtime_event(
                "serve_batch",
                echo=False,
                n=stats.n_requests,
                bucket=stats.bucket,
                wait_ms=round(stats.wait_ms, 3),
            )

    # -- query API ---------------------------------------------------------

    def resolve(self, source: str | None = None,
                source_id: str | None = None,
                row: int | None = None,
                metapath: str | None = None) -> int:
        """Label / node-id / raw row → dense row index (in the
        requested metapath's SOURCE type space — a per-request
        ``metapath`` may start on a different node type than the
        service default)."""
        name = self._canon_metapath(metapath)
        if name == self.metapath.name:
            node_type, n = self.node_type, self.n
        else:
            # compile only: source type and row bound need the SPEC,
            # not an engine — building one here would stall admissions
            # (and burn an engine slot) just to range-check a row
            from ..ops.metapath import compile_metapath

            node_type = compile_metapath(
                name, self.hin.schema
            ).source_type
            n = self.hin.type_size(node_type)
        if row is not None:
            if not 0 <= int(row) < n:
                raise KeyError(f"row {row} out of range [0, {n})")
            return int(row)
        return self.hin.resolve_source(
            node_type, label=source, node_id=source_id
        )

    def _resolve_mode(self, mode: str | None) -> str:
        """Per-request mode override → effective answer path."""
        if mode is None:
            mode = self.config.topk_mode
        if mode not in ("exact", "ann", "learned"):
            raise ValueError(
                f"unknown topk mode {mode!r}; choose 'exact', 'ann' or "
                "'learned'"
            )
        return mode

    def ann_fallback_reason(self, row: int, mode: str | None = None,
                            metapath: str | None = None) -> str | None:
        """Would an (effective-)``ann`` query for ``row`` degrade to
        the exact path right now, and why? A side-effect-free peek —
        no fallback counters tick — for observers: the worker annotates
        responses with it so the router's flight recorder can
        tail-keep ann-degraded requests. None = the ANN path answers
        (or the effective mode is exact, where "fallback" is
        meaningless). A request naming another metapath answers
        exactly (``metapath``): the index embeds the served one."""
        if self._resolve_mode(mode) != "ann":
            return None
        if self._canon_metapath(metapath) != self.metapath.name:
            return "metapath"
        if self._ann is None:
            return "no_index"
        return self._ann.peek(int(row))

    def learned_fallback_reason(self, row: int, mode: str | None = None,
                                metapath: str | None = None) -> str | None:
        """Would a learned-mode query for ``row`` degrade right now,
        and why? Side-effect-free peek (no counters), the twin of
        :meth:`ann_fallback_reason` — the worker annotates responses
        with it so the router's flight recorder can tail-keep
        learned-degraded requests. None = the learned path answers (or
        the effective mode isn't learned). The towers embed the served
        metapath only (``metapath``)."""
        if self._resolve_mode(mode) != "learned":
            return None
        if self._canon_metapath(metapath) != self.metapath.name:
            return "metapath"
        if self._learned is None:
            return "no_towers"
        return self._learned.peek(int(row))

    def _learned_key(self, row: int, k: int) -> tuple:
        """Learned result-cache key: the exact epoch prefix plus a
        ``learned`` axis and the knobs that shape the candidate set —
        a learned answer can never be served to an exact or ann query
        (and vice versa), and retuning cand_mult can't replay old
        shortlists."""
        lr = self._learned
        return (*self._epoch_for(row), "learned", lr.encoder.dim,
                lr.cand_mult, int(row), int(k))

    def _ann_key(self, row: int, k: int) -> tuple:
        """ANN result-cache key: the exact path's epoch prefix (base
        fp + per-row delta version — a delta on this row invalidates
        both tiers' entries the same way) plus an ``ann`` axis so an
        approximate answer can never be served to an exact query or
        vice versa."""
        return (*self._epoch_for(row), "ann", self._ann.variant,
                self._ann.nprobe, self._ann.cand_mult, int(row), int(k))

    def submit_topk(self, row: int, k: int | None = None,
                    mode: str | None = None,
                    metapath: str | None = None) -> Future:
        """Admit a top-k query; returns a Future of (values, indices).
        Cache hits resolve immediately; misses ride the coalescer.
        Raises :class:`coalescer.LoadShedError` at the queue bound.
        ``metapath`` (None → the served one) answers through that
        metapath's engine and lane.

        ``mode`` (None → the service default ``config.topk_mode``)
        picks the answer path: ``exact`` scores the full row; ``ann``
        probes the candidate index and exact-reranks — and silently
        degrades to exact (counted, per reason) whenever the index
        can't vouch for this row (stale/unseen/degenerate/confidence
        lost/no index); ``learned`` probes the towers and exact-reranks,
        degrading ann-then-exact (counted, per reason) the same way.
        Exact is ground truth, so degrading is always safe; it only
        costs the speedup.

        Every admission opens a root ``serve.request`` span: cache hits
        finish it here; coalesced misses carry it across the
        dispatcher/completer thread hop, so one request = one connected
        trace (enqueue → dispatch → device → transfer → cache fill)."""
        k = int(k or self.config.k_default)
        mode = self._resolve_mode(mode)
        name = self._canon_metapath(metapath)
        tracer = get_tracer()
        root = tracer.start_span(
            "serve.request", row=int(row), k=k, mode=mode, metapath=name,
        )
        t0 = time.monotonic()
        try:
            with self._swap_lock:
                if name != self.metapath.name:
                    if mode == "ann":
                        # the candidate index embeds the DEFAULT
                        # metapath's geometry; other chains answer
                        # exactly (counted like every other fallback)
                        get_registry().counter(
                            "dpathsim_ann_fallbacks_total",
                            "ann-requested queries answered exactly "
                            "instead, by reason",
                        ).inc(reason="metapath")
                    elif mode == "learned":
                        # same story for the towers: they embed the
                        # default chain only
                        get_registry().counter(
                            "dpathsim_learned_fallbacks_total",
                            "learned-requested queries degraded to "
                            "ann/exact, by reason",
                        ).inc(reason="metapath")
                    return self._submit_metapath_locked(
                        int(row), k, name, root, t0
                    )
                return self._submit_topk_locked(int(row), k, root, t0,
                                                mode)
        except BaseException as exc:
            tracer.finish(root, outcome=type(exc).__name__)
            raise

    def _answer_cached(self, key: tuple, epoch: tuple, row: int, k: int,
                       n: int, root, t0: float) -> Future | None:
        """Tiers 1 and 2 of an admission: a result-LRU hit, or a known
        score row re-selected for this k on the host. None on a miss."""
        fut = self._result_hit(key, root, t0)
        if fut is not None:
            return fut
        srow = self.tile_cache.get_row(epoch, row)
        if srow is None:
            return None
        masked = srow.copy()
        masked[row] = -np.inf
        k_eff = min(k, max(n - 1, 1))
        vals, idxs = pathsim.topk_from_score_rows(masked[None, :], k_eff)
        self.result_cache.put(key, vals[0], idxs[0])
        fut = Future()
        fut.set_result((vals[0], idxs[0]))
        self._m_latency["hit_tile"].observe(time.monotonic() - t0)
        get_tracer().finish(root, outcome="hit_tile")
        return fut

    def _result_hit(self, key: tuple, root, t0: float) -> Future | None:
        """Tier 1 of an admission: a result-LRU hit, or None."""
        hit = self.result_cache.get(key)
        if hit is None:
            return None
        fut: Future = Future()
        fut.set_result(hit)
        self._m_latency["hit_result"].observe(time.monotonic() - t0)
        get_tracer().finish(root, outcome="hit_result")
        return fut

    def _submit_metapath_locked(self, row: int, k: int, name: str,
                                root=None, t0: float = 0.0) -> Future:
        """Secondary-metapath admission (under ``_swap_lock``): same
        three tiers as the primary path — result LRU, hot-tile
        re-select, coalesced dispatch on the metapath's own lane."""
        eng = self._engine_for(name)
        if not 0 <= row < eng.n:
            raise KeyError(f"row {row} out of range [0, {eng.n})")
        epoch = self._mp_epoch(name)
        fut = self._answer_cached(
            (*epoch, row, k), epoch, row, k, eng.n, root, t0
        )
        if fut is not None:
            return fut
        return self.coalescer.submit(
            row, k, span=root, t_submit=t0, lane=f"{_MP_LANE}{name}"
        )

    def _submit_topk_locked(self, row: int, k: int, root=None,
                            t0: float = 0.0, mode: str = "exact") -> Future:
        # Under _swap_lock: an update/reload drains the pipeline then
        # swaps or patches the backend — admissions must not interleave
        # with that (the drain would never finish, and a request could
        # resolve rows against one graph and dispatch against another).
        if mode == "learned":
            if self._learned is None:
                get_registry().counter(
                    "dpathsim_learned_fallbacks_total",
                    "learned-requested queries degraded to ann/exact, "
                    "by reason",
                ).inc(reason="no_towers")
            elif self._learned.eligible(row) is None:
                fut = self._result_hit(self._learned_key(row, k), root, t0)
                if fut is not None:
                    return fut
                return self.coalescer.submit(
                    row, k, span=root, t_submit=t0, lane="learned"
                )
            # ineligible (counted by reason): degrade ANN-then-exact —
            # the ann cascade below re-checks its own eligibility and
            # counts its own fallbacks, so a doubly-degraded query
            # lands on exact with both arms' accounting intact
            if self._ann is not None:
                mode = "ann"
        if mode == "ann":
            if self._ann is None:
                get_registry().counter(
                    "dpathsim_ann_fallbacks_total",
                    "ann-requested queries answered exactly instead, "
                    "by reason",
                ).inc(reason="no_index")
            elif self._ann.eligible(row) is None:
                fut = self._result_hit(self._ann_key(row, k), root, t0)
                if fut is not None:
                    return fut
                return self.coalescer.submit(
                    row, k, span=root, t_submit=t0, lane="ann"
                )
            # ineligible (already counted by reason): exact fallback
        epoch = self._epoch_for(row)
        fut = self._answer_cached(
            (*epoch, row, k), epoch, row, k, self.n, root, t0
        )
        if fut is not None:
            return fut
        return self.coalescer.submit(row, k, span=root, t_submit=t0)

    def topk_index(self, row: int, k: int | None = None,
                   timeout_s: float | None = None,
                   mode: str | None = None,
                   metapath: str | None = None):
        """Synchronous top-k by dense row index → (values, indices).
        ``timeout_s`` caps the wait below the service-wide default —
        the protocol's ``deadline_ms`` budget lands here, so a request
        whose caller has given up stops blocking a worker slot."""
        timeout = self.config.request_timeout_s
        if timeout_s is not None:
            timeout = min(timeout, max(timeout_s, 0.0))
        return self.submit_topk(
            row, k, mode=mode, metapath=metapath
        ).result(timeout=timeout)

    def _ident(self, i: int, node_type: str | None = None) -> tuple[str, str]:
        """(id, label) for a dense index — huge synthetic graphs carry
        implicit range ids (TypeIndex.size_override, no string tables),
        so serving must synthesize the canonical name rather than index
        an empty tuple."""
        node_type = node_type or self.node_type
        idx = self.hin.indices[node_type]
        if i < len(idx.ids):
            return idx.ids[i], idx.labels[i]
        return f"{node_type}_{i}", f"{node_type}_{i}"

    def source_type(self, metapath: str | None = None) -> str:
        """The node type a request's rows index: the served metapath's
        source type, or a per-request metapath's (compiled, not built)."""
        name = self._canon_metapath(metapath)
        if name == self.metapath.name:
            return self.node_type
        from ..ops.metapath import compile_metapath

        return compile_metapath(name, self.hin.schema).source_type

    def topk(self, source: str | None = None, source_id: str | None = None,
             row: int | None = None, k: int | None = None,
             timeout_s: float | None = None, mode: str | None = None,
             metapath: str | None = None):
        """Synchronous top-k by label / id / row, resolved to ids:
        list of (target_id, target_label, score). ``metapath``
        overrides the served chain per request (default: the service's
        ``--metapath``)."""
        name = self._canon_metapath(metapath)
        # node_type is captured BEFORE dispatch: an update()/reload
        # racing the request may drop the engine dict entry after the
        # future resolves, and a successfully-answered query must not
        # crash on the id-mapping step
        node_type = self.source_type(name)
        r = self.resolve(
            source=source, source_id=source_id, row=row, metapath=name
        )
        vals, idxs = self.topk_index(
            r, k, timeout_s=timeout_s, mode=mode, metapath=name
        )
        return [
            (*self._ident(int(i), node_type), float(v))
            for v, i in zip(vals, idxs)
            if np.isfinite(v)
        ]

    def scores_index(self, row: int,
                     metapath: str | None = None) -> np.ndarray:
        """Full normalized score row (self pair included, as the
        driver's all-pairs row would have it). Tile-cache hit or one
        coalesced dispatch."""
        row = int(row)
        name = self._canon_metapath(metapath)
        if name != self.metapath.name:
            with self._swap_lock:
                self._engine_for(name)
            srow = self.tile_cache.get_row(self._mp_epoch(name), row)
            if srow is not None:
                return srow.copy()
            self.topk_index(row, self.config.k_default, metapath=name)
            # re-fetch engine AND epoch: a delta racing the dispatch
            # advanced _fp and dropped the engine — reading the
            # pre-dispatch snapshot here would serve pre-delta scores
            # as the current answer
            with self._swap_lock:
                eng = self._engine_for(name)
            srow = self.tile_cache.get_row(self._mp_epoch(name), row)
            if srow is not None:
                return srow.copy()
            return eng.backend.scores_rows(
                np.asarray([row]), variant=self.variant
            )[0]
        # copies on the hit paths: callers mutate score rows (self-
        # masking is the natural first move), and handing out the
        # cache's own array would poison every later tier-2 hit
        srow = self.tile_cache.get_row(self._epoch_for(row), row)
        if srow is not None:
            return srow.copy()
        # ride the normal dispatch path (fills the tile cache), then
        # read the row back out of it
        self.topk_index(row, self.config.k_default)
        srow = self.tile_cache.get_row(self._epoch_for(row), row)
        if srow is not None:
            return srow.copy()
        # tile cache disabled (budget 0): compute directly
        return self.backend.scores_rows(
            np.asarray([row]), variant=self.variant
        )[0]

    # -- lifecycle ---------------------------------------------------------

    def invalidate(self, memo: bool = True) -> None:
        """Drop both cache tiers (explicit operator action or reload).
        ``memo=False`` keeps the sub-chain memo — update()'s rebuild
        path uses it after SELECTIVELY invalidating the changed
        factors, so the rebuild's refold still hits the entries whose
        content did not move."""
        self.result_cache.clear()
        self.tile_cache.clear()
        if memo and self.memo is not None:
            self.memo.clear()
        runtime_event("serve_invalidate", fingerprint=self._fp)

    @property
    def consistency_token(self) -> tuple[str, int]:
        """The replica-consistency token ``(base_fp, delta_seq)``: two
        replicas with equal tokens have applied the same delta chain to
        the same base graph and therefore serve bit-identical answers.
        A router fences a replica whose token lags the broadcast head."""
        return (self._base_fp, self._delta_seq)

    def batch_blocks(self, req: dict) -> dict:
        """One batch-campaign block, served off the replica's backend.

        The campaign scheduler (router/batch.py) fans row blocks
        ``[lo, hi)`` here. ``topk`` mode answers through
        ``backend.topk_rows`` — the SAME call the oracle parity tests
        pin — so fleet shards are bit-identical to single-host shards
        by construction; ``simjoin`` mode filters the exact score rows
        at ``tau`` (strictly-upper triangle, the block's share of the
        join). The request's ``(base_fp, delta_seq)`` is the
        campaign's graph identity: a mismatch against this replica's
        consistency token refuses loudly ("stale batch campaign") so a
        delta landing mid-campaign can never mix graph versions into
        one manifest."""
        want_fp = req.get("base_fp")
        if want_fp is not None:
            want = (str(want_fp), int(req.get("delta_seq", 0)))
            if want != self.consistency_token:
                raise ValueError(
                    "stale batch campaign: request pinned graph "
                    f"{want}, replica serves {self.consistency_token}"
                )
        want_mp = req.get("metapath")
        if want_mp is not None and str(want_mp) != self.metapath.name:
            # same fence as the token: a campaign over a different
            # metapath must never mix into this replica's answers
            raise ValueError(
                f"stale batch campaign: request metapath {want_mp!r}, "
                f"replica serves {self.metapath.name!r}"
            )
        lo = int(req.get("lo", 0))
        hi = min(int(req.get("hi", 0)), self.n)
        mode = str(req.get("mode", "topk"))
        variant = str(req.get("variant", self.variant))
        if hi <= lo:
            # an empty range is a valid (if useless) block — the
            # protocol echo test drives every op with no fields
            return {"lo": lo, "hi": hi, "vals": [], "idxs": []}
        rows = np.arange(lo, hi, dtype=np.int64)
        backend = self.backend  # one backend for the block across a swap
        if mode == "topk":
            k = int(req.get("k", self.config.k_default))
            vals, idxs = backend.topk_rows(
                rows, min(k, max(self.n - 1, 1)), variant=variant
            )
            return {
                "lo": lo, "hi": hi,
                "vals": vals.tolist(), "idxs": idxs.tolist(),
            }
        if mode == "simjoin":
            tau = float(req.get("tau", 0.5))
            scores = backend.scores_rows(rows, variant=variant)
            keep = scores >= tau
            keep &= rows[:, None] < np.arange(scores.shape[1])[None, :]
            bi, gj = np.nonzero(keep)
            return {
                "lo": lo, "hi": hi,
                "rows": rows[bi].tolist(), "cols": gj.tolist(),
                "scores": scores[bi, gj].tolist(),
            }
        raise ValueError(f"unknown batch_blocks mode {mode!r}")

    def health(self) -> dict:
        """The heartbeat payload: O(1) liveness + the load signals a
        router routes on + the consistency token that fences a lagging
        replica. Deliberately cheap — a probe must stay answerable even
        when the query path is saturated."""
        c = self.coalescer
        return {
            "ok": True,
            "n": self.n,
            "queue_depth": c.depth,
            "inflight": c.inflight,
            "shed": c.shed_count,
            "base_fp": self._base_fp,
            "delta_seq": self._delta_seq,
            "fingerprint": self._fp,
            "backend": self.backend.name,
            # compaction heartbeat bits: a router (or operator) can see
            # a replica mid-build — the token above is UNCHANGED by a
            # compaction swap, so fencing never reacts to one
            "compaction": {
                "inflight": self._compactor.inflight,
                "count": self._compactor.compactions,
            },
            # index epoch: lets a router (or operator) see which
            # replicas hold a fresh ANN index — a replica without one
            # still answers every query, exactly (None = exact-only)
            "index": (
                {
                    "mode": self.config.topk_mode,
                    "epoch": list(self._ann.index.token),
                    "stale_rows": self._ann.index.stale_count,
                    "enabled": self._ann.enabled,
                }
                if self._ann is not None
                else None
            ),
            # per-mode epoch map: one entry per answer path this replica
            # serves, each with its own consistency epoch — a router
            # re-dispatching a learned query onto a tower-less replica
            # reads this, and the fallback story guarantees the answer
            # is exact either way
            "modes": {
                "exact": {
                    "epoch": [self._base_fp, self._delta_seq],
                    "stale_rows": 0,
                    "enabled": True,
                },
                "ann": (
                    {
                        "epoch": list(self._ann.index.token),
                        "stale_rows": self._ann.index.stale_count,
                        "enabled": self._ann.enabled,
                    }
                    if self._ann is not None else None
                ),
                "learned": (
                    {
                        "epoch": list(self._learned.token),
                        "stale_rows": self._learned.stale_count,
                        "pending_appends": self._learned.pending_appends,
                        "enabled": self._learned.enabled,
                    }
                    if self._learned is not None else None
                ),
            },
            # process-lifetime compile count (kernel builds and loads):
            # a steady-state replica whose number moves is violating
            # the shape-bucket contract
            "compiles": compiles_total(),
        }

    def update(self, delta, want_rows: bool = False) -> dict:
        """Absorb a :class:`~..data.delta.DeltaBatch` into the WARM
        service — the alternative to :meth:`reload` that keeps every
        shape and every unaffected cache entry.

        Fast path (plan says patch): drain the pipeline, patch the
        backend's half factor/denominators in place (O(Δ + affected
        rows), no new compile), bump the cache version of exactly the
        affected score rows, and purge only their entries — every
        unaffected row keeps its cached answers. Fallback (headroom
        exhausted / Δ over threshold / backend or chain without a patch
        path): build a fresh backend for the delta-applied graph and
        swap it in, reload-style.

        An update that would push a path count past the backend's
        exactness guard (f32 counts ≥ 2^24) is refused with
        OverflowError before anything changes: the backend, its factor,
        the graph, the denominators, the consistency token and both
        cache tiers stay as they were. On the patch path the check runs
        before anything changes, so the sub-chain memo and the secondary
        metapath engines stay as they were too; on the rebuild path
        (the guard runs on the new backend) the memo entries over the
        changed factors and the engines are gone — caches both, rebuilt
        on demand. (The JAX package's service patches first and raises
        after, leaving a half-applied state.)

        Every update drops the memo entries over the factors it changed
        and every secondary engine (they rebuild lazily), and feeds the
        compactor: an in-flight build's replay log, the chain counter
        and the headroom trigger.

        Returns an accounting dict (mode, affected rows, purges,
        chained fingerprint, memo entries and engines dropped) — also
        the JSONL ``update`` op's result."""
        from ..backends.base import DeltaUnsupported
        from ..data.delta import plan_delta

        t0 = time.perf_counter()
        with self._swap_lock:
            # every issued batch completes (its GEMM and copy done)
            # before the factor is written
            self.coalescer.drain()
            plan = plan_delta(
                self.hin, delta, self.metapath,
                max_delta_fraction=self.config.delta_threshold,
            )
            mode, reason = "delta", plan.reason
            if not plan.fallback:
                # refuse a guard-tripping update while nothing has
                # changed; the rebuild path's guard runs in
                # _install_backend, before the swap
                self.backend.check_delta(plan)
                try:
                    self.backend.apply_delta(plan)
                except DeltaUnsupported as exc:
                    mode, reason = "rebuild", str(exc)
            else:
                mode = "rebuild"
            # Sub-chain memo: drop exactly the entries whose factors
            # changed (keys are content fingerprints, so untouched
            # sub-chains keep hitting across the delta); secondary
            # engines bind the pre-delta graph and rebuild lazily.
            changed_rels = sorted({e.relationship for e in delta.edges})
            memo_dropped = (
                self.memo.invalidate_relationships(changed_rels)
                if self.memo is not None else 0
            )
            with self._engines_lock:
                engines_dropped = len(self._engines)
                self._engines.clear()
            affected_list: list[int] | None = None
            if mode == "rebuild":
                self._install_backend(
                    self._backend_factory(plan.hin_new),
                    warm=self.config.warm,
                )
                # answer caches go wholesale; the sub-chain memo was
                # already SELECTIVELY invalidated above — its surviving
                # entries are content-addressed (still bit-valid for
                # untouched factors), and the rebuild's refold just
                # hit them through the factory's threaded memo
                self.invalidate(memo=False)
                self._update_stats["rebuilds"] += 1
                affected_n, purged = self.n, -1  # everything went
            else:
                self.hin = plan.hin_new
                self.index = self.hin.indices[self.node_type]
                self.n = self.index.size
                self._d = np.asarray(
                    self.backend._denominators(self.variant),
                    dtype=np.float64,
                )
                affected = plan.affected_rows
                self._row_ver[affected] += 1
                purged = self.result_cache.purge_rows(
                    affected
                ) + self.tile_cache.purge_rows(affected)
                self._delta_seq += 1
                self._fp = plan.fingerprint
                affected_n = int(affected.shape[0])
                if self._ann is not None:
                    # the index's rows for this delta are now a graph
                    # behind: fence them onto the exact path until the
                    # (background) refresh re-embeds them. Appended
                    # rows are uncovered by construction.
                    self._ann.index.mark_stale(affected)
                if self._learned is not None:
                    # the same fence for the towers: affected rows answer
                    # exactly until absorb() re-embeds them; appended
                    # source rows (headroom slots made real) go
                    # cold-start pending (the SLO gauge tracks them)
                    self._learned.mark_stale(affected)
                    self._learned.note_appends(sum(
                        a.n for a in plan.delta.nodes
                        if a.node_type == self.node_type
                    ))
                    self._learned_deltas += 1
                if want_rows:
                    # a router's fencing needs the SET, not the count: a
                    # replica that missed this delta is fenced for
                    # exactly these rows until caught up
                    affected_list = [int(r) for r in affected]
                self._update_stats["deltas"] += 1
                self._update_stats["purged_rows"] += purged
            # compaction bookkeeping + trigger check (we hold the swap
            # lock): a patch feeds an in-flight build's replay log; a
            # long chain or thin headroom spawns the background build
            self._compactor.note_update(delta, mode)
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            self._m_updates.inc(mode=mode)
            get_registry().histogram(
                "dpathsim_serve_update_seconds",
                "delta-update end-to-end latency by mode",
            ).observe((time.perf_counter() - t0), mode=mode)
            runtime_event(
                "serve_update",
                mode=mode,
                reason=reason,
                edge_changes=plan.n_edge_changes,
                node_appends=plan.delta.n_node_appends,
                affected_rows=affected_n,
                purged_entries=purged,
                delta_seq=self._delta_seq,
                fingerprint=self._fp,
                ms=ms,
            )
            result = {
                "mode": mode,
                "reason": reason,
                "edge_changes": plan.n_edge_changes,
                "node_appends": plan.delta.n_node_appends,
                "affected_rows": affected_n,
                "purged_entries": purged,
                "memo_invalidated": memo_dropped,
                "engines_dropped": engines_dropped,
                "delta_seq": self._delta_seq,
                "base_fp": self._base_fp,
                "fingerprint": self._fp,
                "n": self.n,
                "ms": ms,
            }
            if want_rows:
                # None under rebuild: "all rows" — the fence must cover
                # everything, not an empty set
                result["affected_row_list"] = affected_list
            if self._ann is not None:
                result["ann_stale_rows"] = self._ann.index.stale_count
                if (
                    mode == "delta"
                    and self.config.ann_auto_refresh
                    and self._ann.index.stale_count
                    # only the struct map re-embeds in place
                    and self._ann.index.meta.get("embedding") == "struct"
                    # debounced: one refresh in flight at a time — a
                    # sustained delta stream must not spawn a thread
                    # (and pay a half-chain fold) per delta only to
                    # abandon at the token check; the in-flight
                    # refresh snapshots the token AFTER taking the
                    # lock, so it folds the newest graph state anyway
                    and not self._ann_refresh_inflight
                ):
                    # background re-embed: stale rows answer exactly in
                    # the meantime, so serving correctness never waits
                    # on this thread (it blocks on the swap lock we
                    # still hold, then runs). The spawning update's
                    # span context rides along as a LINK: the refresh
                    # runs as its own trace, but its root span names
                    # the update span that caused it.
                    cur = get_tracer().current()
                    link = (
                        f"{cur.trace_id}:{cur.span_id}"
                        if cur is not None and cur.span_id else None
                    )
                    self._ann_refresh_inflight = True
                    threading.Thread(
                        target=self._refresh_index_quietly,
                        args=(link,),
                        name="pathsim-ann-refresh", daemon=True,
                    ).start()
            if self._learned is not None:
                result["learned_stale_rows"] = self._learned.stale_count
                result["learned_pending_appends"] = (
                    self._learned.pending_appends
                )
                if (
                    mode == "delta"
                    and self.config.learned_auto_refresh
                    and (
                        self._learned.stale_count
                        or self._learned.pending_appends
                    )
                    # cadence knob: a sustained delta stream re-embeds
                    # every Nth landing (staled rows answer exactly in
                    # the meantime: speed only, never correctness)
                    and self._learned_deltas >= self._learned_refresh_every
                    # debounced like the ann refresh: one in flight
                    and not self._learned_refresh_inflight
                ):
                    cur = get_tracer().current()
                    link = (
                        f"{cur.trace_id}:{cur.span_id}"
                        if cur is not None and cur.span_id else None
                    )
                    self._learned_refresh_inflight = True
                    self._learned_deltas = 0
                    threading.Thread(
                        target=self._refresh_towers_quietly,
                        args=(link,),
                        name="pathsim-learned-refresh", daemon=True,
                    ).start()
            return result

    def _refresh_index_quietly(self, link: str | None = None) -> None:
        try:
            # its own root span (head sampling applies — a refresh is a
            # background job, not a request), LINKED to the update that
            # scheduled it via the ``link`` arg ("trace:span")
            with get_tracer().span("ann.refresh", link=link):
                while True:
                    # an abandoned attempt (a newer delta landed
                    # mid-fold) retries against the newer token —
                    # deltas that arrived while we were the debounced
                    # in-flight refresh must not be left stale until
                    # some future update happens by
                    result = self.refresh_index()
                    if result.get("abandoned"):
                        continue
                    # Close the debounce window: a delta landing after
                    # refresh_index released the swap lock but before
                    # we clear the flag saw inflight=True and skipped
                    # scheduling — its staleness is ours to absorb.
                    # Re-check under the lock that owns both the flag
                    # and the index; the progress guard (refreshed > 0)
                    # keeps rows refresh CANNOT clear from spinning this
                    # thread forever.
                    with self._swap_lock:
                        ann = self._ann
                        more = (
                            ann is not None
                            and ann.index.meta.get("embedding") == "struct"
                            and ann.index.stale_count
                            and result.get("refreshed", 0) > 0
                        )
                        if not more:
                            self._ann_refresh_inflight = False
                            return
        except Exception as exc:  # background thread: report, never die
            runtime_event("ann_refresh_failed", error=repr(exc))
            with self._swap_lock:
                self._ann_refresh_inflight = False

    def refresh_index(self) -> dict:
        """Re-embed every delta-staled index row in place and advance
        the index's consistency token to the service's — the
        "background refresh" half of the staleness contract.
        Embeddings come from the PATCHED graph on the index's pinned
        quadrature grid/projection, so refreshed rows stay
        inner-product-consistent with the rest of the index. Rows the
        index cannot hold (appended past the build) stay on the exact
        path; the accounting reports them. Also re-snapshots C/d for
        the exact rerank and resets the shadow-recall gate (old
        evidence described the old index state).

        The expensive inputs (half-chain fold, re-embedding) are
        computed OUTSIDE the swap lock against a token snapshot —
        serving keeps flowing while they build — and applied under the
        lock only if no further delta landed meanwhile (a newer delta
        has already scheduled its own refresh, so abandoning is
        correct, not lossy). The probe's device mirror is dropped with
        the pipeline drained, so no probe in flight reads a
        half-refreshed block."""
        from ..index.build import (
            half_chain_and_denominators, refresh_embeddings,
        )

        t0 = time.perf_counter()
        with self._swap_lock:
            ann = self._ann
            if ann is None:
                return {"ann": False, "refreshed": 0}
            if ann.index.meta.get("embedding") != "struct":
                result = {
                    "ann": True, "refreshed": 0,
                    "stale_remaining": ann.index.stale_count,
                    "unsupported": "learned-embedding index: rebuild "
                    "offline (dpathsim-torch index build) and reload",
                }
                runtime_event("ann_refresh_unavailable", **result)
                return result
            token0 = self.consistency_token
            hin = self.hin
            stale_rows = np.flatnonzero(ann.index.stale)
        tracer = get_tracer()
        with tracer.child_span(
            "index.half_chain_fold", stale=int(stale_rows.size)
        ):
            c, d = half_chain_and_denominators(
                hin, self.metapath, self.variant
            )
        emb = (
            refresh_embeddings(ann.index, stale_rows, c, d)
            if stale_rows.size else None
        )
        with self._swap_lock:
            if self._ann is not ann or self.consistency_token != token0:
                runtime_event(
                    "ann_refresh_abandoned", token=list(token0),
                    reason="newer delta landed during the re-embed",
                )
                return {"ann": True, "refreshed": 0, "abandoned": True}
            # drained like update(): the probe reads the index arrays
            # this refresh mutates, and a batch must never straddle it
            self.coalescer.drain()
            unplaced: list[int] = []
            if emb is not None:
                unplaced = ann.index.refresh_rows(
                    stale_rows, emb, token=token0
                )
            else:
                ann.index.token = token0
            c.flags.writeable = False
            ann.c64 = c
            ann.d = d
            if ann.variant == "rerank-all":
                ann.rebind_counts()  # blocks must mirror the new slots
            ann.reset_confidence()
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            result = {
                "ann": True,
                "refreshed": int(stale_rows.size) - len(unplaced),
                "unplaced": len(unplaced),
                "stale_remaining": ann.index.stale_count,
                "uncovered_rows": max(self.n - ann.index.n, 0),
                "token": list(ann.index.token),
                "ms": ms,
            }
            runtime_event("ann_refresh", **result)
            return result

    def _refresh_towers_quietly(self, link: str | None = None) -> None:
        try:
            with get_tracer().span("learned.refresh", link=link):
                while True:
                    # abandoned attempts (a newer delta landed mid-fold)
                    # retry against the newer token — the newer update
                    # saw inflight=True and skipped scheduling, so its
                    # staleness is ours to absorb
                    result = self.refresh_towers()
                    if result.get("abandoned"):
                        continue
                    with self._swap_lock:
                        lr = self._learned
                        more = (
                            lr is not None
                            and (lr.stale_count or lr.pending_appends)
                            and result.get("refreshed", 0) > 0
                        )
                        if not more:
                            self._learned_refresh_inflight = False
                            return
        except Exception as exc:  # background thread: report, never die
            runtime_event("learned_refresh_failed", error=repr(exc))
            with self._swap_lock:
                self._learned_refresh_inflight = False

    def refresh_towers(self) -> dict:
        """Absorb the patched graph into the learned tier: swap in the
        current C/d snapshot and re-embed exactly the stale + appended
        rows through the inductive encoder on the towers' device — O(Δ)
        tower work, nothing compiled, the cold-start path that makes a
        never-seen appended author answerable in learned mode before any
        full re-embed. Mirrors :meth:`refresh_index`'s locking: the
        half-chain fold runs OUTSIDE the swap lock against a token
        snapshot; the absorb applies under the lock with the pipeline
        drained (no probe in flight reads the embeddings it replaces)
        only if no further delta landed meanwhile. A contraction-width
        change (a new venue vocabulary moved the feature space) is
        reported, not raised — the service keeps degrading those rows,
        correctly, until retrained."""
        from ..index.build import half_chain_and_denominators

        t0 = time.perf_counter()
        with self._swap_lock:
            lr = self._learned
            if lr is None:
                return {"learned": False, "refreshed": 0}
            token0 = self.consistency_token
            hin = self.hin
            stale_n = lr.stale_count
            pending = lr.pending_appends
        tracer = get_tracer()
        with tracer.child_span(
            "learned.half_chain_fold", stale=stale_n, appends=pending
        ):
            c, d = half_chain_and_denominators(
                hin, self.metapath, self.variant
            )
        with self._swap_lock:
            if self._learned is not lr or self.consistency_token != token0:
                runtime_event(
                    "learned_refresh_abandoned", token=list(token0),
                    reason="newer delta landed during the fold",
                )
                return {"learned": True, "refreshed": 0, "abandoned": True}
            self.coalescer.drain()
            try:
                with tracer.child_span("learned.absorb"):
                    acct = lr.absorb(c, d, token0)
            except ValueError as exc:
                result = {
                    "learned": True, "refreshed": 0,
                    "stale_remaining": lr.stale_count,
                    "unsupported": str(exc),
                }
                runtime_event("learned_refresh_unavailable", **result)
                return result
            # old shadow evidence described the pre-absorb towers
            lr.reset_confidence()
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            result = {
                "learned": True,
                "refreshed": acct["re_embedded"],
                "appended": acct["appended"],
                "stale_remaining": lr.stale_count,
                "pending_appends": lr.pending_appends,
                "token": list(lr.token),
                "ms": ms,
            }
            runtime_event("learned_refresh", **result)
            return result

    def reload(self, backend: PathSimBackend) -> None:
        """Swap in a freshly built backend (graph reload): drain the
        in-flight pipeline, install + rewarm, invalidate both cache
        tiers. Queries submitted after return are answered from the new
        graph — and the epoch key guarantees no stale entry can ever be
        served even across the swap."""
        with self._swap_lock:
            self.coalescer.drain()
            old_fp = self._fp
            self._install_backend(backend, warm=self.config.warm)
            self.invalidate()
            runtime_event(
                "serve_reload", from_fingerprint=old_fp,
                to_fingerprint=self._fp,
            )

    def _apply_compaction(self, backend: PathSimBackend, hin_c,
                          token0: tuple) -> dict:
        """The compaction-swap doorway: the ONLY path by which a
        compaction-built backend enters service (serving/compact.py is
        the sole caller). Under the swap lock: verify the build's token
        snapshot still chains to the live token (a reload/rebuild
        re-based it → abandon), replay the deltas that landed mid-build
        onto the new backend (O(Δ) each; the build pre-folded the half
        chain), drain the pipeline, and hot-swap. The drain comes before
        the swap, so no batch in flight on the old backend outlives its
        buffers. Returns either ``{"abandoned": reason}`` or the swap
        accounting (replayed count, pause seconds, new capacities)."""
        from ..backends.base import DeltaUnsupported
        from ..data.delta import plan_delta

        comp = self._compactor
        with self._swap_lock:
            log = comp._log
            want = (
                (token0[0], token0[1] + len(log))
                if log is not None else None
            )
            if want is None or self.consistency_token != want:
                return {"abandoned": "token moved during build"}
            t_pause = time.perf_counter()
            hin_cur = hin_c
            for delta in log:
                plan = plan_delta(
                    hin_cur, delta, self.metapath,
                    max_delta_fraction=self.config.delta_threshold,
                )
                if plan.fallback:
                    return {"abandoned": "replayed delta fell back"}
                try:
                    backend.apply_delta(plan)
                except DeltaUnsupported:
                    return {"abandoned": "replayed delta unsupported"}
                hin_cur = plan.hin_new
            with get_tracer().child_span(
                "compact.swap", replayed=len(log)
            ):
                self.coalescer.drain()
                self._swap_compacted(backend, hin_cur)
            comp._chain = 0
            return {
                "replayed_deltas": len(log),
                "pause_s": time.perf_counter() - t_pause,
                "capacity": {
                    t: idx.padded_size
                    for t, idx in hin_cur.indices.items()
                    if idx.capacity is not None
                },
                "token": list(self.consistency_token),
            }

    def _swap_compacted(self, backend: PathSimBackend, hin) -> None:
        """Install a compaction-built backend for the SAME logical
        graph. Caller (:meth:`_apply_compaction`) holds ``_swap_lock``
        with the pipeline drained. Unlike :meth:`_install_backend`
        this preserves the consistency token, the chained fingerprint,
        the per-row cache versions, and BOTH cache tiers — the graph
        content did not change, only its physical padding — so router
        fencing sees nothing and every warm entry stays servable. The
        bucket ladder is untouched (keyed on the unchanged logical n),
        and no rewarm runs here: the build thread warmed the new
        padded shapes before taking the lock."""
        d = np.asarray(backend._denominators(self.variant), dtype=np.float64)
        self.backend = backend
        self.hin = hin
        # engines bind the old hin generation; they rebuild lazily
        with self._engines_lock:
            self._engines.clear()
        self.index = self.hin.indices[self.node_type]
        self.n = self.index.size
        old_ver = self._row_ver
        new_ver = np.zeros(self.index.padded_size, dtype=np.int64)
        m = min(old_ver.shape[0], new_ver.shape[0])
        new_ver[:m] = old_ver[:m]
        self._row_ver = new_ver
        self._d = d

    def compact(self, wait_s: float = 300.0) -> dict:
        """Force one compaction now (the ``compact`` protocol op): the
        same build-then-hot-swap the automatic triggers run, executed
        synchronously. Returns the compaction accounting (``swapped``,
        replayed deltas, build/pause ms, compile count, new per-type
        capacities). Serving keeps flowing during the build; only the
        swap itself (drain + replay + install) pauses admissions."""
        return self._compactor.compact_now(
            reason="requested", wait_s=wait_s
        )

    def _engine_summaries(self) -> dict:
        with self._engines_lock:
            engines = sorted(self._engines.items())
        return {
            name: {
                "backend": eng.backend.name,
                "n": eng.n,
                "fallback_from": eng.fallback_from,
                **eng.backend.plan.summary(),
            }
            for name, eng in engines
        }

    def stats(self) -> dict:
        c = self.coalescer
        batches = max(c.batch_count, 1)
        # live latency quantiles from the obs registry: stats() answers
        # "where is the p99 right now" without anyone replaying JSONL
        lat = {}
        for outcome, cell in self._m_latency.items():
            if cell.count:
                lat[outcome] = {
                    "count": cell.count,
                    "p50_ms": round(cell.quantile(0.50) * 1e3, 4),
                    "p95_ms": round(cell.quantile(0.95) * 1e3, 4),
                    "p99_ms": round(cell.quantile(0.99) * 1e3, 4),
                }
        from .. import tuning

        table = tuning.active_table()
        return {
            "obs": {
                "latency": lat,
                "tracing": get_tracer().enabled,
                "metrics": get_registry().enabled,
                "tuning": {
                    "table": table.digest if table is not None else None,
                    "lookups": tuning.lookup_stats(),
                    "buckets": list(self._bucket_ladder),
                },
            },
            "n": self.n,
            "metapath": self.metapath.name,
            "variant": self.variant,
            "backend": self.backend.name,
            "fingerprint": self._fp,
            # the primary plan's association order + cost estimates,
            # every live secondary engine's, and the sub-chain memo
            # accounting
            "plan": {
                "primary": self.backend.plan.summary(),
                "engines": self._engine_summaries(),
                "memo": (
                    self.memo.stats() if self.memo is not None else None
                ),
            },
            "factor": self.backend.factor_info(),
            "topk_mode": self.config.topk_mode,
            "ann": self._ann.snapshot() if self._ann is not None else None,
            "learned": (
                self._learned.snapshot()
                if self._learned is not None else None
            ),
            "delta": {
                "seq": self._delta_seq,
                "base_fingerprint": self._base_fp,
                "headroom": self.index.headroom,
                **self._update_stats,
            },
            # background compaction: trigger state, swap/abandon/failure
            # counters, and the last swap's build/pause/compile numbers
            "compaction": self._compactor.snapshot(),
            "result_cache": {
                "hits": self.result_cache.hits,
                "misses": self.result_cache.misses,
                "entries": len(self.result_cache),
                "evictions": self.result_cache.evictions,
            },
            "tile_cache": {
                "hits": self.tile_cache.hits,
                "misses": self.tile_cache.misses,
                "bytes": self.tile_cache.bytes_used,
                "evictions": self.tile_cache.evictions,
            },
            "dispatch": {
                "batches": c.batch_count,
                "requests": c.dispatched_requests,
                "shed": c.shed_count,
                "mean_batch": round(c.dispatched_requests / batches, 3),
                "mean_wait_ms": round(self._wait_ms_sum / batches, 3),
                "buckets": dict(sorted(self._bucket_hist.items())),
            },
        }

    def close(self) -> None:
        # an in-flight compaction build finishes (swap or abandon) before
        # the pipeline closes under it
        self._compactor._done.wait(self.config.request_timeout_s)
        self.coalescer.close()
        # a closed service answers nothing: its engines' device factors go
        with self._engines_lock:
            self._engines.clear()
        if self._ann is not None:
            self._ann.close()
        if self._learned is not None:
            self._learned.close()


def build_service(
    config,
    serve_config: ServeConfig | None = None,
    timer=None,
    hin=None,
):
    """RunConfig → warm PathSimService (engine bootstrap + serving
    wrap): the one-call path of the ``serve`` and ``worker`` CLIs.
    ``hin`` (an encoded graph) takes the place of ``config.dataset``."""
    from ..backends.base import create_backend
    from ..engine import backend_options, build_backend

    t0 = time.perf_counter()
    _, metapath, backend = build_backend(config, timer=timer, hin=hin)
    service = PathSimService(
        backend,
        variant=config.variant,
        config=serve_config,
        # delta-fallback rebuilds and compactions replay the full
        # RunConfig knobs, with the service's sub-chain memo threaded in
        # so a refold hits the entries the delta did not invalidate
        backend_factory=lambda hin: create_backend(
            config.backend, hin, metapath,
            subchain_memo=service.memo,
            **backend_options(config),
        ),
    )
    runtime_event(
        "serve_ready",
        backend=backend.name,
        n=service.n,
        metapath=service.metapath.name,
        startup_s=round(time.perf_counter() - t0, 3),
    )
    return service
