"""The batch campaign engine: top-k for EVERY row as a blocked sweep.

The port of the JAX package's ``batch/campaign.py``. A campaign is the
corpus-scale twin of the serving path: the same plan-ordered half-chain
fold (ops/planner.py), the same packed factor surface (ops/packed.py),
and the same f64 scoring / tie-order primitives (ops/pathsim.py) —
pointed at all N rows instead of one request. Per row block ``[lo,
hi)`` the sweep computes ``M[lo:hi, :] = C[lo:hi] @ Cᵀ`` as one
fixed-shape f64 GEMM on the card (blocks are padded to ``block_rows``,
a pow-2 resolved through the tuning ladder, so every block has one
shape), with ``Cᵀ`` resident on the card in f64 once per campaign;
normalizes on host in f64, and selects through
``pathsim.topk_from_score_rows`` — bit-identical to the serving
oracle's ``backend.topk_rows`` because every count that enters the
division is an exact integer in f64 (< 2⁵³) under ANY association
order, and selection shares the (descending score, ascending column)
tie order. There is no silent host fallback: on the card the GEMM runs
on the card or the campaign raises; the host (numpy) arm is taken only
when the engine is built for the CPU (``--platform cpu``).

Campaigns checkpoint per block through
:class:`~..utils.checkpoint.CheckpointManager`. The manifest's
identity config is content-addressed — keyed on ``(base_fp,
delta_seq, metapath, variant, k|τ, block_rows, factor_format)`` — so
resuming against a graph that absorbed a delta mid-campaign is
refused loudly (the manager's config mismatch), never silently mixed.
SIGTERM lands between blocks: the in-flight block's shard is already
durable when :func:`~..resilience.preemption.PreemptionHandler.check`
raises, so a resume skips completed blocks and re-produces
byte-identical shard outputs (DESIGN.md §31).

Block decode (the packed-chunk gather) runs on a prefetch thread,
double-buffered against the current block's GEMM, so decode overlaps
matmul without changing result bytes (the consumer drains blocks in
issue order). The prefetch thread touches only host arrays: every copy
to the card, and the GEMM that reads it, is issued by the consuming
thread on its own stream, so the copy is ordered before the GEMM.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time

import numpy as np
import torch

from ..obs.metrics import get_registry
from ..obs.trace import get_tracer
from ..ops import packed, pathsim, planner
from ..resilience import preemption_handler
from ..serving.cache import graph_fingerprint
from ..utils.checkpoint import CheckpointManager
from ..utils.device import resolve_device
from ..utils.logging import runtime_event

# The block-sweep doorway registry (the PROTOCOL_OPS / PACKED_SURFACE /
# COMPACTION_SURFACE pattern): these engine primitives skip the campaign
# layer's checkpoint manifest, stale-graph fencing, and preemption
# accounting. Calling them from anywhere but the campaign runners
# (batch/campaign.py, batch/simjoin.py) produces results no manifest
# owns — un-resumable, un-fenced, and invisible to the batch metrics —
# so tests/test_torch_hygiene.py seals them inside this package.
BATCH_SURFACE = frozenset({
    "sweep_topk_block", "sweep_scores_block", "sweep_pair_block",
})

# CheckpointManager's on-disk format key: bumping it refuses stale
# directories from an incompatible layout instead of misreading them.
_MANIFEST_FORMAT = "batch-v1"


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A campaign's content-addressed identity — exactly the fields
    that change result bytes. This dict IS the checkpoint manifest's
    ``__config__``: two campaigns with equal specs over equal graphs
    produce byte-identical shards, and a resume against a different
    spec (a delta landed, a different k/τ, a re-tuned block size) is
    refused by the manager's config check."""

    mode: str                # "topk" | "simjoin"
    metapath: str
    variant: str
    base_fp: str
    delta_seq: int
    block_rows: int
    factor_format: str
    k: int | None = None
    tau: float | None = None
    grouping: str = "natural"   # simjoin row grouping: natural|degree|centroid

    def manifest_config(self) -> dict:
        cfg = {
            "format": _MANIFEST_FORMAT,
            "mode": self.mode,
            "metapath": self.metapath,
            "variant": self.variant,
            "base_fp": self.base_fp,
            "delta_seq": int(self.delta_seq),
            "block_rows": int(self.block_rows),
            "factor_format": self.factor_format,
        }
        if self.k is not None:
            cfg["k"] = int(self.k)
        if self.tau is not None:
            cfg["tau"] = float(self.tau)
        if self.mode == "simjoin":
            cfg["grouping"] = self.grouping
        return cfg


def block_ranges(n: int, block_rows: int) -> list[tuple[int, int]]:
    """The campaign's work units: contiguous ``[lo, hi)`` row ranges,
    every block ``block_rows`` wide except a short tail (which the
    engine pads back to full width before the GEMM)."""
    return [
        (lo, min(lo + block_rows, n)) for lo in range(0, n, block_rows)
    ]


class BatchEngine:
    """The campaign's compute core: one plan-ordered half-chain
    factor, its denominators, the resident ``Cᵀ`` GEMM operand, and
    the fixed-shape block primitives every campaign mode shares.

    An engine binds a SNAPSHOT of the graph: ``(base_fp, delta_seq)``
    at construction is the identity every shard and every fleet
    dispatch is fenced against.

    ``device``: None means the card (``Cᵀ`` resident there in f64, every
    block's GEMM on it, raising without a card); ``"cpu"`` takes the
    host numpy arm."""

    def __init__(
        self,
        hin,
        metapath,
        variant: str = "rowsum",
        factor_format: str | None = None,
        block_rows: int | None = None,
        delta_seq: int = 0,
        device=None,
    ):
        if variant not in ("rowsum", "diagonal"):
            raise ValueError(f"unknown PathSim variant {variant!r}")
        self.hin = hin
        self.metapath = metapath
        self.variant = variant
        self.n = int(hin.type_size(metapath.source_type))
        if self.n < 2:
            raise ValueError("batch campaigns need at least two rows")
        self.delta_seq = int(delta_seq)
        self.base_fp = graph_fingerprint(hin)
        from .. import tuning

        fmt = factor_format
        if fmt is None:
            fmt = str(tuning.choose("factor_format", n=self.n, default="coo"))
        self.factor_format = fmt
        self.device = resolve_device(device)  # before the fold
        # The half-chain fold stays behind the planner doorway:
        # packed.fold_half delegates to planner.fold_half, so the
        # association order is the EvalPlan's DP order.
        self.plan = planner.plan_metapath(hin, metapath)
        self.factor = packed.fold_half(hin, metapath, fmt)
        self.v = int(self.factor.shape[1])
        g = packed.factor_colsum(self.factor)
        if variant == "rowsum":
            # d = C·g — row sums of M without materializing M (the
            # same identity the partition workers' denominators use)
            self.d = packed.factor_rowsums_weighted(self.factor, g)
        else:
            self.d = packed.factor_diag(self.factor)
        if block_rows is None:
            block_rows = int(tuning.choose(
                "batch_block_rows", n=self.n, default=256,
            ))
        from ..tuning.registry import resolve_ladder

        # snap to the pow-2 ladder: one block shape → one compiled
        # program → zero steady-state recompiles, by construction
        self.block_rows = int(
            resolve_ladder("pow2", max(int(block_rows), 1))[-1]
        )
        # COO arm: one row-sorted index built up front so arbitrary-row
        # gathers are O(nnz gathered), like the packed accessor's
        self._coo_order = None
        self._coo_indptr = None
        if not packed.is_packed(self.factor):
            c = packed.as_coo(self.factor)
            order = np.argsort(c.rows, kind="stable")
            self._coo_order = (
                c.rows[order], c.cols[order],
                np.asarray(c.weights, dtype=np.float64)[order],
            )
            self._coo_indptr = np.searchsorted(
                self._coo_order[0], np.arange(self.n + 1)
            )
        # The GEMM's right operand, resident once per campaign and
        # amortized over every block (the sweep's whole point: N/B
        # blocks share one decode of Cᵀ).
        self._ct = np.ascontiguousarray(
            self._gather_dense(np.arange(self.n, dtype=np.int64)).T
        )
        # On the card: Cᵀ in f64, resident for the campaign. The host arm
        # is the CPU engine's, never a fallback from the card.
        self._ct_dev = (
            torch.as_tensor(self._ct).to(self.device)
            if self.device.type == "cuda" else None
        )
        self.backend_mode = "cuda" if self._ct_dev is not None else "numpy"
        reg = get_registry()
        self._m_backend = reg.counter(
            "dpathsim_batch_score_backend_total",
            "batch block GEMMs by execution backend (cuda = the card's "
            "f64 GEMM; numpy = the host arm of a --platform cpu engine)",
        )
        self._m_rows = reg.counter(
            "dpathsim_batch_rows_total", "campaign rows computed",
        )
        # honest read-volume accounting: decoded factor bytes (COO-
        # equivalent stream of the gathered block rows) + the resident
        # operand bytes each block's GEMM streams
        self.bytes_decoded = 0
        self.bytes_operand = 0
        runtime_event(
            "batch_engine_ready", echo=False,
            n=self.n, v=self.v, block_rows=self.block_rows,
            factor_format=fmt, backend=self.backend_mode,
            base_fp=self.base_fp, delta_seq=self.delta_seq,
        )

    # -- spec / identity ---------------------------------------------------

    def spec(
        self,
        mode: str,
        k: int | None = None,
        tau: float | None = None,
        grouping: str = "natural",
    ) -> CampaignSpec:
        return CampaignSpec(
            mode=mode, metapath=self.metapath.name, variant=self.variant,
            base_fp=self.base_fp, delta_seq=self.delta_seq,
            block_rows=self.block_rows, factor_format=self.factor_format,
            k=k, tau=tau, grouping=grouping,
        )

    def _gather_dense(self, rows: np.ndarray) -> np.ndarray:
        """Dense [len(rows), V] gather for ANY resident format: packed
        layouts go through the sanctioned accessor; the coo arm reads
        the row-sorted copy built at init. Same exact f64 integers
        either way (the packed round trip is property-tested)."""
        if packed.is_packed(self.factor):
            return packed.gather_rows_dense(self.factor, rows)
        crows, ccols, cw = self._coo_order
        indptr = self._coo_indptr
        starts = indptr[rows]
        counts = indptr[rows + 1] - starts
        out = np.zeros((rows.shape[0], self.v), dtype=np.float64)
        total = int(counts.sum())
        if total == 0:
            return out
        ridx = np.repeat(np.arange(rows.shape[0]), counts)
        cum = np.concatenate([[0], np.cumsum(counts)])
        flat = np.repeat(starts, counts) + (
            np.arange(total) - np.repeat(cum[:-1], counts)
        )
        out[ridx, ccols[flat]] = cw[flat]
        return out

    # -- block primitives (the sealed surface) -----------------------

    def decode_block(self, lo: int, hi: int):
        """Gather rows ``[lo, hi)`` dense and pad to ``block_rows`` by
        repeating the first row (the serving buckets' pad idiom: pad
        rows are sliced off before anything downstream sees them, so
        padding is semantically inert and shapes stay fixed)."""
        rows = np.arange(lo, hi, dtype=np.int64)
        bd = self._gather_dense(rows)
        self.bytes_decoded += int(np.count_nonzero(bd)) * 24
        if bd.shape[0] < self.block_rows:
            pad = np.broadcast_to(
                bd[:1], (self.block_rows - bd.shape[0], self.v)
            )
            bd = np.concatenate([bd, pad], axis=0)
        return rows, bd

    def _product(self, bd: np.ndarray, ct_dev, ct: np.ndarray):
        """``bd @ ct`` on the engine's arm: the card's f64 GEMM against
        the resident operand, or the host's. Both arms produce identical
        bytes: counts are exact integers in f64, so the summation order
        cannot move them."""
        if self._ct_dev is not None:
            m = pathsim.device_counts(bd, ct_dev)
            self._m_backend.inc(backend="cuda")
        else:
            m = bd @ ct
            self._m_backend.inc(backend="numpy")
        self.bytes_operand += int(ct.nbytes)
        return m

    def _counts(self, bd: np.ndarray) -> np.ndarray:
        """``bd @ Cᵀ`` against the campaign's resident operand."""
        return self._product(bd, self._ct_dev, self._ct)

    def sweep_topk_block(self, lo: int, hi: int, k: int, decoded=None):
        """Top-k for rows ``[lo, hi)``: (values f64 [B, k'], indices
        int64 [B, k']) with k' = min(k, N−1), self pairs excluded —
        row-for-row bit-identical to ``backend.topk_rows`` (same
        integer counts, same f64 normalization, same tie order)."""
        rows, bd = decoded if decoded is not None else self.decode_block(
            lo, hi
        )
        m = self._counts(bd)[: rows.shape[0]]
        scores = pathsim.score_rows(m, self.d[rows], self.d, xp=np)
        scores[np.arange(rows.shape[0]), rows] = -np.inf
        vals, idxs = pathsim.topk_from_score_rows(
            scores, min(int(k), max(self.n - 1, 1))
        )
        self._m_rows.inc(float(rows.shape[0]))
        return vals, idxs

    def sweep_scores_block(self, lo: int, hi: int, decoded=None):
        """Raw f64 score rows for ``[lo, hi)`` (self pair INCLUDED,
        exactly as the oracle's score row has it) — the simjoin
        diagonal blocks and the parity harness read this."""
        rows, bd = decoded if decoded is not None else self.decode_block(
            lo, hi
        )
        m = self._counts(bd)[: rows.shape[0]]
        self._m_rows.inc(float(rows.shape[0]))
        return rows, pathsim.score_rows(m, self.d[rows], self.d, xp=np)

    def sweep_pair_block(self, rows_i: np.ndarray, cols_j: np.ndarray):
        """Exact score sub-block for arbitrary row/column sets — the
        simjoin exact-fallback path. Both index sets are padded to
        ``block_rows`` (repeat-first, sliced off afterwards) so every
        pair block shares ONE compiled program shape. Scores go
        through ``pathsim.score_candidates``, which is entry-for-entry
        bit-identical to the corresponding ``score_rows`` column."""
        rows_i = np.asarray(rows_i, dtype=np.int64)
        cols_j = np.asarray(cols_j, dtype=np.int64)
        bi, bj = int(rows_i.shape[0]), int(cols_j.shape[0])
        br = self.block_rows

        def _pad(ix):
            if ix.shape[0] >= br:
                return ix
            return np.concatenate(
                [ix, np.full(br - ix.shape[0], ix[0], dtype=np.int64)]
            )

        ri, cj = _pad(rows_i), _pad(cols_j)
        bd = self._gather_dense(ri)
        self.bytes_decoded += int(np.count_nonzero(bd)) * 24
        ct = np.ascontiguousarray(self._ct[:, cj])
        ct_dev = (
            None if self._ct_dev is None
            else self._ct_dev[:, torch.as_tensor(cj, device=self.device)]
        )
        m = self._product(bd, ct_dev, ct)[:bi, :bj]
        d_cand = np.broadcast_to(self.d[cols_j], (bi, bj))
        return pathsim.score_candidates(m, self.d[rows_i], d_cand, xp=np)


@dataclasses.dataclass
class CampaignResult:
    """What a finished campaign hands back (topk mode: the assembled
    per-row arrays; simjoin mode: the pair lists — see simjoin.py)."""

    spec: CampaignSpec
    vals: np.ndarray | None
    idxs: np.ndarray | None
    blocks_total: int
    blocks_resumed: int
    rows_per_s: float
    elapsed_s: float
    bytes_decoded: int
    bytes_operand: int
    backend_mode: str

    @property
    def bytes_read_per_row(self) -> float:
        n = self.vals.shape[0] if self.vals is not None else 1
        return (self.bytes_decoded + self.bytes_operand) / max(n, 1)


def _block_key(lo: int, hi: int) -> str:
    return f"b{lo:09d}-{hi:09d}"


class _Prefetcher:
    """Decode-ahead thread: gathers block ``i+1`` while block ``i``
    matmuls. Bounded queue (one block in flight) keeps the resident
    transient at two decoded blocks; issue order is preserved, so the
    overlap cannot reorder — or change — a single output byte."""

    def __init__(self, engine: BatchEngine, blocks: list[tuple[int, int]]):
        self._engine = engine
        self._blocks = blocks
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._t = threading.Thread(
            target=self._run, name="pathsim-batch-prefetch", daemon=True,
        )
        self._t.start()

    def _run(self) -> None:
        try:
            for lo, hi in self._blocks:
                self._q.put((lo, hi, self._engine.decode_block(lo, hi)))
            self._q.put(None)
        except BaseException as exc:  # surface decode failures in order
            self._q.put(exc)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def run_topk_campaign(
    engine: BatchEngine,
    k: int,
    checkpoint_dir: str | None = None,
    emit_pairs: str | None = None,
    on_block=None,
    scheduler=None,
) -> CampaignResult:
    """Top-k-for-every-row: sweep all blocks, checkpointing each as it
    completes. ``scheduler`` (router/batch.BlockScheduler) fans the
    pending blocks across a worker fleet via the ``batch_blocks`` wire
    op instead of computing locally; either way each block's shard is
    saved atomically before the next preemption check, so SIGTERM →
    resume skips completed blocks bit-identically.

    ``on_block(done, total)`` fires after every completed block — the
    smoke's preemption injection point, and a progress hook."""
    spec = engine.spec("topk", k=int(k))
    ck = (
        CheckpointManager(checkpoint_dir, config=spec.manifest_config())
        if checkpoint_dir else None
    )
    blocks = block_ranges(engine.n, engine.block_rows)
    mem: dict[str, dict] = {}
    resumed = 0
    pending: list[tuple[int, int]] = []
    for lo, hi in blocks:
        if ck is not None and ck.is_done(_block_key(lo, hi)):
            resumed += 1
        else:
            pending.append((lo, hi))
    reg = get_registry()
    g_total = reg.gauge(
        "dpathsim_batch_blocks", "campaign blocks by completion state",
    )
    g_total.set(float(len(blocks)), state="total")
    g_total.set(float(resumed), state="done")
    g_rate = reg.gauge(
        "dpathsim_batch_rows_per_s",
        "campaign throughput, rows/sec over this run's computed blocks",
    )
    tracer = get_tracer()
    t0 = time.perf_counter()
    done = resumed
    k_eff = min(int(k), max(engine.n - 1, 1))

    def _save(lo: int, hi: int, vals: np.ndarray, idxs: np.ndarray):
        nonlocal done
        key = _block_key(lo, hi)
        if ck is not None:
            ck.save_unit(key, vals=vals, idxs=idxs)
        else:
            mem[key] = {"vals": vals, "idxs": idxs}
        done += 1
        g_total.set(float(done), state="done")
        elapsed = time.perf_counter() - t0
        rows_done = done * engine.block_rows
        g_rate.set(rows_done / max(elapsed, 1e-9))
        if on_block is not None:
            on_block(done, len(blocks))
        preemption_handler.check(checkpoint_dir=checkpoint_dir)

    with tracer.span(
        "batch.campaign", mode="topk", k=k_eff,
        blocks=len(blocks), resumed=resumed,
    ):
        if scheduler is not None and pending:
            for lo, hi, result in scheduler.map_blocks(spec, pending):
                with tracer.span("batch.block", lo=lo, hi=hi):
                    vals = np.asarray(result["vals"], dtype=np.float64)
                    idxs = np.asarray(result["idxs"], dtype=np.int64)
                    _save(lo, hi, vals, idxs)
        else:
            for lo, hi, decoded in _Prefetcher(engine, pending):
                with tracer.span("batch.block", lo=lo, hi=hi):
                    vals, idxs = engine.sweep_topk_block(
                        lo, hi, k_eff, decoded=decoded
                    )
                    _save(lo, hi, vals, idxs)
    elapsed = time.perf_counter() - t0
    vals = np.full((engine.n, k_eff), -np.inf)
    idxs = np.zeros((engine.n, k_eff), dtype=np.int64)
    for lo, hi in blocks:
        unit = (
            ck.load_unit(_block_key(lo, hi)) if ck is not None
            else mem[_block_key(lo, hi)]
        )
        vals[lo:hi] = unit["vals"]
        idxs[lo:hi] = unit["idxs"]
    computed_rows = sum(hi - lo for lo, hi in pending)
    result = CampaignResult(
        spec=spec, vals=vals, idxs=idxs,
        blocks_total=len(blocks), blocks_resumed=resumed,
        rows_per_s=computed_rows / max(elapsed, 1e-9),
        elapsed_s=elapsed,
        bytes_decoded=engine.bytes_decoded,
        bytes_operand=engine.bytes_operand,
        backend_mode=(
            "fleet" if scheduler is not None else engine.backend_mode
        ),
    )
    if emit_pairs:
        export_pairs(emit_pairs, vals, idxs)
    runtime_event(
        "batch_campaign_done", echo=False, mode="topk",
        blocks=len(blocks), resumed=resumed,
        rows_per_s=round(result.rows_per_s, 1),
        elapsed_s=round(elapsed, 3),
    )
    return result


def export_pairs(path: str, vals: np.ndarray, idxs: np.ndarray) -> None:
    """The ``--emit-pairs`` training export (the JAX package's learned
    index distills from exactly this stream): one JSONL record per
    finite (row, neighbor, score) hit. JSON round-trips f64 exactly
    (shortest-repr), so a consumer reading these floats gets the
    campaign's bytes back."""
    with open(path, "w", encoding="utf-8") as f:
        for row in range(vals.shape[0]):
            for v, j in zip(vals[row], idxs[row]):
                if not np.isfinite(v):
                    continue
                f.write(json.dumps(
                    {"row": int(row), "col": int(j), "score": float(v)}
                ) + "\n")
