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

The port serves the EXACT lane of the JAX package's service. Its ANN
and learned lanes, per-request secondary metapaths, the router batch
op and background compaction are not ported yet; ``update`` falls back
to the synchronous rebuild when headroom runs out, as the JAX service
does with compaction off.
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
from ..utils.compile_counter import (
    compiles_total,
    install_compile_metrics,
    warm_compile_cache,
)
from ..utils.logging import runtime_event
from .buckets import resolve_ladder
from .cache import HotTileCache, ResultCache, graph_fingerprint
from .coalescer import BatchStats, Coalescer, Request


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
        # update()'s full-rebuild fallback needs a fresh backend for the
        # delta-applied graph. The default rebuilds with the incumbent's
        # class and pass-through options; build_service installs a
        # factory that replays the full RunConfig knobs.
        self._backend_factory = backend_factory or (
            lambda hin: type(self.backend)(
                hin, self.metapath, **self.backend.options
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
            for outcome in ("hit_result", "hit_tile", "dispatch")
        }
        self._m_updates = reg.counter(
            "dpathsim_serve_updates_total",
            "delta-update outcomes (patch vs rebuild)",
        )
        # compiles visible live: a steady-state serving process whose
        # counter moves is violating the shape-bucket contract
        install_compile_metrics()
        self._install_backend(backend, warm=self.config.warm)
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
        self.backend = backend
        self.hin = backend.hin
        self.metapath = backend.metapath
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

    # -- dispatch plumbing (runs on coalescer threads) ---------------------

    def _issue(self, rows_padded: np.ndarray, k: int, lane: str = "exact"):
        """Dispatcher-thread half of a batch: returns the in-flight
        counts handle. The torch backend returns a handle on a GEMM
        queued on its serving stream (the double buffer overlaps the
        host copy with the next bucket's GEMM); others return host
        counts directly."""
        issue_device = getattr(self.backend, "pairwise_rows_device", None)
        if issue_device is not None:
            handle = issue_device(rows_padded)
            if handle is not None:
                return handle
        return self.backend.pairwise_rows(rows_padded)

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
        cache tiers, resolve futures. The tracer spans opened here
        parent into the batch's ``serve.complete`` span — the coalescer
        activated its context on this thread before calling."""
        tracer = get_tracer()
        with tracer.child_span("serve.host_transfer", n=int(rows.shape[0])):
            # column trim to the logical width: handles from a
            # capacity-padded backend carry zero-count pad columns.
            # np.asarray is where a device handle actually blocks — the
            # transfer segment of the trace.
            counts = np.asarray(handle, dtype=np.float64)[
                : rows.shape[0], : self.n
            ]
        scores = pathsim.score_rows(counts, self._d[rows], self._d, xp=np)
        masked = scores.copy()
        masked[np.arange(rows.shape[0]), rows] = -np.inf
        k_eff = min(k, max(self.n - 1, 1))
        vals, idxs = pathsim.topk_from_score_rows(masked, k_eff)
        with tracer.child_span("serve.cache_fill", n=len(batch)):
            for b, req in enumerate(batch):
                epoch = self._epoch_for(int(rows[b]))
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
                row: int | None = None) -> int:
        """Label / node-id / raw row → dense row index."""
        if row is not None:
            if not 0 <= int(row) < self.n:
                raise KeyError(f"row {row} out of range [0, {self.n})")
            return int(row)
        return self.hin.resolve_source(
            self.node_type, label=source, node_id=source_id
        )

    def submit_topk(self, row: int, k: int | None = None) -> Future:
        """Admit a top-k query; returns a Future of (values, indices).
        Cache hits resolve immediately; misses ride the coalescer.
        Raises :class:`coalescer.LoadShedError` at the queue bound.

        Every admission opens a root ``serve.request`` span: cache hits
        finish it here; coalesced misses carry it across the
        dispatcher/completer thread hop, so one request = one connected
        trace (enqueue → dispatch → device → transfer → cache fill)."""
        k = int(k or self.config.k_default)
        tracer = get_tracer()
        root = tracer.start_span(
            "serve.request", row=int(row), k=k, mode="exact",
            metapath=self.metapath.name,
        )
        t0 = time.monotonic()
        try:
            with self._swap_lock:
                return self._submit_topk_locked(int(row), k, root, t0)
        except BaseException as exc:
            tracer.finish(root, outcome=type(exc).__name__)
            raise

    def _submit_topk_locked(self, row: int, k: int, root=None,
                            t0: float = 0.0) -> Future:
        # Under _swap_lock: an update/reload drains the pipeline then
        # swaps or patches the backend — admissions must not interleave
        # with that (the drain would never finish, and a request could
        # resolve rows against one graph and dispatch against another).
        tracer = get_tracer()
        epoch = self._epoch_for(row)
        key = (*epoch, int(row), k)
        hit = self.result_cache.get(key)
        if hit is not None:
            fut: Future = Future()
            fut.set_result(hit)
            self._m_latency["hit_result"].observe(time.monotonic() - t0)
            tracer.finish(root, outcome="hit_result")
            return fut
        srow = self.tile_cache.get_row(epoch, int(row))
        if srow is not None:
            masked = srow.copy()
            masked[int(row)] = -np.inf
            k_eff = min(k, max(self.n - 1, 1))
            vals, idxs = pathsim.topk_from_score_rows(
                masked[None, :], k_eff
            )
            self.result_cache.put(key, vals[0], idxs[0])
            fut = Future()
            fut.set_result((vals[0], idxs[0]))
            self._m_latency["hit_tile"].observe(time.monotonic() - t0)
            tracer.finish(root, outcome="hit_tile")
            return fut
        return self.coalescer.submit(int(row), k, span=root, t_submit=t0)

    def topk_index(self, row: int, k: int | None = None,
                   timeout_s: float | None = None):
        """Synchronous top-k by dense row index → (values, indices).
        ``timeout_s`` caps the wait below the service-wide default —
        the protocol's ``deadline_ms`` budget lands here, so a request
        whose caller has given up stops blocking a worker slot."""
        timeout = self.config.request_timeout_s
        if timeout_s is not None:
            timeout = min(timeout, max(timeout_s, 0.0))
        return self.submit_topk(row, k).result(timeout=timeout)

    def _ident(self, i: int) -> tuple[str, str]:
        """(id, label) for a dense index — huge synthetic graphs carry
        implicit range ids (TypeIndex.size_override, no string tables),
        so serving must synthesize the canonical name rather than index
        an empty tuple."""
        idx = self.hin.indices[self.node_type]
        if i < len(idx.ids):
            return idx.ids[i], idx.labels[i]
        return f"{self.node_type}_{i}", f"{self.node_type}_{i}"

    def topk(self, source: str | None = None, source_id: str | None = None,
             row: int | None = None, k: int | None = None,
             timeout_s: float | None = None):
        """Synchronous top-k by label / id / row, resolved to ids:
        list of (target_id, target_label, score)."""
        r = self.resolve(source=source, source_id=source_id, row=row)
        vals, idxs = self.topk_index(r, k, timeout_s=timeout_s)
        return [
            (*self._ident(int(i)), float(v))
            for v, i in zip(vals, idxs)
            if np.isfinite(v)
        ]

    def scores_index(self, row: int) -> np.ndarray:
        """Full normalized score row (self pair included, as the
        driver's all-pairs row would have it). Tile-cache hit or one
        coalesced dispatch."""
        row = int(row)
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

    def invalidate(self) -> None:
        """Drop both cache tiers (explicit operator action or reload)."""
        self.result_cache.clear()
        self.tile_cache.clear()
        runtime_event("serve_invalidate", fingerprint=self._fp)

    @property
    def consistency_token(self) -> tuple[str, int]:
        """The replica-consistency token ``(base_fp, delta_seq)``: two
        replicas with equal tokens have applied the same delta chain to
        the same base graph and therefore serve bit-identical answers.
        A router fences a replica whose token lags the broadcast head."""
        return (self._base_fp, self._delta_seq)

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
            # per-mode epoch map: the exact lane is the only one ported
            "modes": {
                "exact": {
                    "epoch": [self._base_fp, self._delta_seq],
                    "stale_rows": 0,
                    "enabled": True,
                },
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
        cache tiers stay as they were. (The JAX package's service
        patches first and raises after, leaving a half-applied state.)

        Returns an accounting dict (mode, affected rows, purges,
        chained fingerprint) — also the JSONL ``update`` op's result."""
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
            affected_list: list[int] | None = None
            if mode == "rebuild":
                self._install_backend(
                    self._backend_factory(plan.hin_new),
                    warm=self.config.warm,
                )
                self.invalidate()
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
                if want_rows:
                    # a router's fencing needs the SET, not the count: a
                    # replica that missed this delta is fenced for
                    # exactly these rows until caught up
                    affected_list = [int(r) for r in affected]
                self._update_stats["deltas"] += 1
                self._update_stats["purged_rows"] += purged
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
        return {
            "obs": {
                "latency": lat,
                "tracing": get_tracer().enabled,
                "metrics": get_registry().enabled,
                "buckets": list(self._bucket_ladder),
            },
            "n": self.n,
            "metapath": self.metapath.name,
            "variant": self.variant,
            "backend": self.backend.name,
            "fingerprint": self._fp,
            "plan": {"primary": self.backend.plan.summary()},
            "factor": self.backend.factor_info(),
            "topk_mode": "exact",
            "delta": {
                "seq": self._delta_seq,
                "base_fingerprint": self._base_fp,
                "headroom": self.index.headroom,
                **self._update_stats,
            },
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
        self.coalescer.close()


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
        # delta-fallback rebuilds replay the full RunConfig knobs
        backend_factory=lambda hin: create_backend(
            config.backend, hin, metapath, **backend_options(config)
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
