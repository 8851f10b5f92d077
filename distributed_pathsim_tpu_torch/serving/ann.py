"""Serving-side ANN state: candidates → exact f64 rerank, with guards.

The service owns one :class:`AnnState` when ``--topk-mode ann`` (or an
``--index`` artifact) is configured. It bundles:

- the :class:`~..index.CentroidIndex` (probe = one batched matmul on
  the index's device);
- the half-chain factor C and denominator vector d snapshotted at the
  index's consistency token — the exact-rerank inputs, host f64.
  Counts are integers, so the snapshot's candidate scores are
  bit-identical to the live backend's for every row the delta
  machinery has not marked affected (unaffected rows' score rows did
  not change); affected rows are stale in the index and answer through
  the exact path until refresh.
- **shadow-recall confidence**: every Nth ANN dispatch also runs the
  exact oracle for its row and folds recall@k into
  ``dpathsim_ann_recall_ratio``. When the measured ratio drops below
  the floor (enough samples seen), ANN answering disables itself —
  every query falls back to exact until a refresh/rebuild restores
  confidence.

Fallback taxonomy (``dpathsim_ann_fallbacks_total{reason=...}``):
``stale`` (row touched by an un-refreshed delta), ``uncovered`` (row
appended after the build — the index has never seen it),
``degenerate`` (zero denominator: the exact path's all-zero answer is
already O(1)), ``low_confidence`` (shadow gate tripped), ``no_index``
(ann requested but no index installed).

The rerank is the JAX package's ``serving/ann.py`` arithmetic on the
host (``ops/pathsim.score_candidates`` / ``topk_from_candidate_scores``),
which is what makes a port ANN answer bit-identical to the JAX one.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..obs.metrics import get_registry
from ..ops import pathsim
from ..utils.logging import runtime_event

FALLBACK_REASONS = (
    "stale", "uncovered", "degenerate", "low_confidence", "no_index",
)


class AnnState:
    """One service's ANN answering state. Thread discipline: eligibility
    checks run under the service's swap lock; rerank/shadow run on the
    coalescer's completion thread; refresh swaps the snapshots under
    the swap lock with the pipeline drained."""

    def __init__(
        self,
        index,
        c64: np.ndarray,
        d: np.ndarray,
        nprobe: int,
        cand_mult: int,
        variant: str = "rerank-all",
        shadow_every: int = 64,
        recall_floor: float = 0.98,
        min_shadow: int = 8,
    ):
        if variant not in ("rerank-all", "shortlist"):
            raise ValueError(f"unknown ann probe variant {variant!r}")
        self.index = index
        self.c64 = np.asarray(c64, dtype=np.float64)
        self.c64.flags.writeable = False
        self.d = np.asarray(d, dtype=np.float64)
        self.nprobe = int(nprobe)
        self.cand_mult = int(cand_mult)
        self.variant = variant
        # rerank-all reads the half-chain factor through per-cluster
        # packed blocks (contiguous [cap, V] slices per probed
        # cluster); rebuilt by rebind_counts after any refresh
        self._blocks: np.ndarray | None = None
        self.route_on_host = False
        if variant == "rerank-all":
            self.rebind_counts()
            # tiny routing work: host numpy beats torch's per-op
            # overhead when the index probes on the CPU anyway; on a
            # card the route runs there
            self.route_on_host = index.torch_device().type == "cpu"
        self.shadow_every = max(int(shadow_every), 0)
        self.recall_floor = float(recall_floor)
        self.min_shadow = int(min_shadow)
        self.enabled = True
        # per-request reranks inside one batch are independent — a
        # small pool keeps every core on the BLAS/numpy work (which
        # releases the GIL) instead of serializing ~1 ms reranks on
        # the single completion thread
        self.pool = ThreadPoolExecutor(
            max_workers=max(2, min(4, os.cpu_count() or 2)),
            thread_name_prefix="pathsim-ann-rerank",
        )
        self._lock = threading.Lock()
        self.shadow_n = 0
        self.recall_sum = 0.0
        self._since_shadow = 0
        reg = get_registry()
        self._m_requests = reg.counter(
            "dpathsim_ann_requests_total",
            "topk requests answered through the ANN path",
        ).labels()
        self._m_fallbacks = reg.counter(
            "dpathsim_ann_fallbacks_total",
            "ann-requested queries answered exactly instead, by reason",
        )
        self._m_recall = reg.gauge(
            "dpathsim_ann_recall_ratio",
            "measured shadow recall@k of the ANN path vs the exact "
            "oracle (cumulative over the shadow samples)",
        ).labels()
        self._m_recall.set(1.0)
        self._m_probe = reg.histogram(
            "dpathsim_ann_probe_seconds",
            "ANN candidate-generation (index probe) latency per batch",
        ).labels()
        self._m_rerank = reg.histogram(
            "dpathsim_ann_rerank_seconds",
            "exact candidate rerank latency per request",
        ).labels()

    # -- eligibility -------------------------------------------------------

    def peek(self, row: int) -> str | None:
        """Eligibility WITHOUT the counter side effect: the fallback
        reason that would apply, or None. Observers (the worker's
        response annotation, the flight recorder's classification)
        read this; only the answering path (:meth:`eligible`) counts —
        otherwise one degraded request would tick the fallback counter
        once per onlooker."""
        with self._lock:
            enabled = self.enabled
        if not enabled:
            return "low_confidence"
        if not self.index.covers(row):
            return "stale" if 0 <= row < self.index.n else "uncovered"
        if not (0 <= row < self.d.shape[0]) or self.d[row] <= 0:
            return "degenerate"
        return None

    def eligible(self, row: int) -> str | None:
        """None when the ANN path may answer ``row``; otherwise the
        fallback reason (also counted)."""
        reason = self.peek(row)
        if reason is not None:
            self.note_fallback(reason)
        return reason

    def note_fallback(self, reason: str) -> None:
        self._m_fallbacks.inc(reason=reason)

    # -- the probe ----------------------------------------------------------

    def issue(self, rows_padded: np.ndarray):
        """The dispatcher-thread half of an ``ann`` batch: the route
        (``rerank-all``) or the shortlist probe, as handles the
        completion thread fetches with ``np.asarray`` (host arrays
        when routing on the host)."""
        index = self.index
        if self.variant == "rerank-all":
            if self.route_on_host:
                return index.route_batch_host(rows_padded, self.nprobe)
            return index.route_batch_pending(rows_padded, self.nprobe)
        return index.probe_batch_pending(rows_padded, self.nprobe)

    # -- the exact rerank --------------------------------------------------

    def rebind_counts(self) -> None:
        """(Re)pack the C snapshot into index-aligned per-cluster
        blocks [K, cap, V] (f64; pad slots zero). Called at setup and
        after every refresh — the blocks must mirror the index's slot
        layout exactly, or a probed member would rerank against some
        other row's counts."""
        members = self.index.members
        safe = np.maximum(members, 0)
        blocks = self.c64[safe.reshape(-1)].reshape(
            members.shape[0], members.shape[1], self.c64.shape[1]
        )
        blocks[members < 0] = 0.0
        self._blocks = blocks

    def rerank_all(
        self, row: int, mem_row: np.ndarray, top_c_row: np.ndarray,
        k: int, n: int,
    ):
        """``rerank-all`` completion: exact f64 top-k over EVERY member
        of the probed clusters — no approximate shortlist cut at all,
        so recall equals cluster-routing recall. The counts matmul
        reads contiguous packed blocks; pads/self (−1) and
        beyond-logical-n rows (capacity padding) are masked out of the
        tie-ordered selection."""
        q = self.c64[row]
        cap = self._blocks.shape[1]
        counts = np.empty(top_c_row.shape[0] * cap, dtype=np.float64)
        # per-cluster GEMVs over contiguous block VIEWS — a fancy-index
        # gather of the probed blocks would copy ~nprobe·cap·V·8 bytes
        # per query before the matmul even reads them
        for j, cl in enumerate(top_c_row):
            counts[j * cap:(j + 1) * cap] = self._blocks[cl] @ q
        cols = mem_row.astype(np.int64)
        cols = np.where(cols >= n, -1, cols)
        d_cand = self.d[np.maximum(cols, 0)]
        scores = pathsim.score_candidates(
            counts[None, :], np.asarray([self.d[row]]), d_cand[None, :]
        )
        vals, idxs = pathsim.topk_from_candidate_scores(
            scores, cols[None, :], k
        )
        return vals[0], idxs[0]

    def candidates_for(
        self, sims_row: np.ndarray, mem_row: np.ndarray, k: int, n: int
    ) -> np.ndarray:
        """Top-C candidate ids for one probed row (C = cand_mult·k,
        clamped to the probed set and to N−1)."""
        n_cand = max(k, min(self.cand_mult * k, n - 1, sims_row.shape[0]))
        cand = self.index.select_candidates(sims_row, mem_row, n_cand)
        return cand[(cand >= 0) & (cand < n)]

    def rerank(self, row: int, cand: np.ndarray, k: int):
        """Exact f64 top-k over the candidate set: integer counts from
        the C snapshot (O(C·V)), shared normalize + tie order with the
        full exact path (ops/pathsim.score_candidates /
        topk_from_candidate_scores) — bit-identical to the full-row
        answer whenever the true top-k is inside ``cand``."""
        cand = np.asarray(cand, dtype=np.int64)
        counts = self.c64[cand] @ self.c64[row]
        scores = pathsim.score_candidates(
            counts[None, :], np.asarray([self.d[row]]), self.d[cand][None, :]
        )
        vals, idxs = pathsim.topk_from_candidate_scores(
            scores, cand[None, :], k
        )
        return vals[0], idxs[0]

    # -- shadow-recall confidence ------------------------------------------

    def should_shadow(self) -> bool:
        if self.shadow_every <= 0:
            return False
        with self._lock:
            self._since_shadow += 1
            if self._since_shadow >= self.shadow_every:
                self._since_shadow = 0
                return True
        return False

    def record_shadow(self, ann_vals, exact_vals, k: int) -> None:
        """Fold one shadow comparison into the confidence gate.
        Recall@k is SCORE recall: a returned item whose exact score is
        ≥ the oracle's k-th score is a hit. On integer-count graphs the
        top-k boundary routinely sits inside a large set of exactly
        tied scores, and the id-based metric would punish returning a
        tie-equivalent member — an answer the exact engine itself only
        prefers by the arbitrary ascending-column convention. A
        genuinely better-scoring member that the index missed is still
        a miss under this metric (ann scores are exact, so the
        comparison is bit-meaningful)."""
        ev = np.asarray(exact_vals)
        av = np.asarray(ann_vals)
        want = ev[np.isfinite(ev)]
        if want.size == 0:
            return
        kth = want.min()
        got = av[np.isfinite(av)]
        recall = min(
            float((got >= kth).sum()) / float(want.size), 1.0
        )
        with self._lock:
            self.shadow_n += 1
            self.recall_sum += recall
            ratio = self.recall_sum / self.shadow_n
            tripped = (
                self.enabled
                and self.shadow_n >= self.min_shadow
                and ratio < self.recall_floor
            )
            if tripped:
                self.enabled = False
            samples = self.shadow_n
        self._m_recall.set(ratio)
        if tripped:
            runtime_event(
                "ann_confidence_lost",
                recall=round(ratio, 4),
                floor=self.recall_floor,
                samples=samples,
            )

    def close(self) -> None:
        self.pool.shutdown(wait=False)

    def reset_confidence(self) -> None:
        """After a refresh/rebuild the old shadow evidence describes a
        different index state — start the gate fresh."""
        with self._lock:
            self.shadow_n = 0
            self.recall_sum = 0.0
            self._since_shadow = 0
            self.enabled = True
        self._m_recall.set(1.0)

    # -- accounting --------------------------------------------------------

    def count_answered(self) -> None:
        self._m_requests.inc()

    def observe_probe(self, seconds: float) -> None:
        self._m_probe.observe(seconds)

    def observe_rerank(self, seconds: float) -> None:
        self._m_rerank.observe(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            ratio = (
                self.recall_sum / self.shadow_n if self.shadow_n else None
            )
            return {
                "enabled": self.enabled,
                "variant": self.variant,
                "nprobe": self.nprobe,
                "cand_mult": self.cand_mult,
                "centroids": self.index.n_centroids,
                "cluster_cap": self.index.cluster_cap,
                "dim": self.index.dim,
                "indexed_rows": self.index.n,
                "stale_rows": self.index.stale_count,
                "token": list(self.index.token),
                "embedding": self.index.meta.get("embedding"),
                "shadow_samples": self.shadow_n,
                "shadow_recall": (
                    round(ratio, 6) if ratio is not None else None
                ),
            }
