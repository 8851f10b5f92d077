"""Serving-side learned-tower state: candidates → exact f64 rerank.

The service owns one :class:`LearnedState` when ``--topk-mode learned``
(or ``--learned-checkpoint``) is configured. The safety story is the
ANN arm's (serving/ann.py):

- the towers ONLY generate candidates. Every served answer is
  exact-f64 reranked on the host through the candidate-restricted
  primitives the exact engine uses (``ops/pathsim.score_candidates`` /
  ``topk_from_candidate_scores``) against the C/d snapshot, so a
  learned answer is bit-identical to the full exact top-k whenever the
  true top-k is inside the candidate set — and the shadow gate
  MEASURES how often that holds;
- **shadow-recall confidence**: every Nth learned dispatch also runs
  the exact oracle; measured score-recall below the floor disables the
  learned arm (every query degrades, counted) until a refresh;
- **cold start**: rows a delta touched or appended re-embed through the
  inductive encoder's row-local forward at :meth:`LearnedState.absorb`
  — O(Δ) tower work, no full corpus re-embed, nothing compiled.

Where the work runs: the corpus embeddings stay resident on the
state's device (CUDA unless the service runs on the host) in f32; the
probe — one [B, dim] × [dim, N] product in true f32, the self mask and
the top-C pick (a stable descending sort: equal similarities keep the
lowest row first) — runs there on the state's own stream, and only the
[B, C] candidate ids cross to the host, fetched on the completion
thread through ``backends/torch_dense.PendingRows``. C and d stay on the
host, read-only f64, for the rerank.

Fallback taxonomy (``dpathsim_learned_fallbacks_total{reason=...}``):
``no_towers``, ``stale``, ``uncovered``, ``degenerate``,
``low_confidence``, ``metapath``. Every degradation falls to
ANN-then-exact in the service's admission cascade.

**The raw-score doorway**: raw tower similarities are approximations
and must never reach a host boundary unreranked — an operator reading
them as PathSim scores would be silently wrong in score units.
``LEARNED_SURFACE`` names the raw-score internals (the JAX package's
analyzer rule LN001 reads the same registry); no module outside
``learned/`` names them (``tests/test_torch_hygiene.py``). In the port
the similarities never leave the device at all: the probe handle
carries candidate ids, and answers leave this module only through
:meth:`LearnedState.answer_from_handle`, which reranks exactly.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..obs.metrics import get_registry
from ..ops import pathsim
from ..utils.logging import runtime_event

LEARNED_FALLBACK_REASONS = (
    "no_towers", "stale", "uncovered", "degenerate", "low_confidence",
    "metapath",
)

# The sealed raw-score surface: attributes that read or carry UNRERANKED
# tower similarities. Only modules inside learned/ may name them
# (``raw_sims`` is the JAX package's handle payload; the port's handle
# carries candidate ids, so the name must stay unused elsewhere too).
LEARNED_SURFACE = frozenset({
    "tower_sims",
    "raw_sims",
})


def _n_cand(k: int, cand_mult: int, n: int) -> int:
    """Candidates a request of ``k`` reranks: C = cand_mult·k, at least
    k, at most every other row (the JAX package's rule)."""
    return max(k, min(cand_mult * k, n - 1))


class ProbeHandle:
    """One batch's probe between the dispatcher and completion threads:
    the top-C candidate ids per row ([B, C], best first, self excluded
    while C < N), pending on the device until :meth:`fetch`."""

    __slots__ = ("cand",)

    def __init__(self, cand):
        self.cand = cand

    def fetch(self) -> np.ndarray:
        """Block until the ids are on the host (the completion thread's
        transfer); later calls return the host array."""
        if not isinstance(self.cand, np.ndarray):
            self.cand = np.asarray(self.cand, dtype=np.int64)
        return self.cand


class LearnedState:
    """One service's learned answering state. Thread discipline
    mirrors :class:`~..serving.ann.AnnState`: eligibility under the
    service's swap lock; probe issued on the dispatcher thread (on the
    state's stream); fetch, rerank and shadow on the completion thread;
    absorb/refresh under the swap lock with the pipeline drained."""

    def __init__(
        self,
        encoder,
        c64: np.ndarray,
        d: np.ndarray,
        cand_mult: int = 16,
        shadow_every: int = 64,
        recall_floor: float = 0.98,
        min_shadow: int = 8,
        token: tuple[str, int] = ("", 0),
        device=None,
    ):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.encoder = encoder
        self.c64 = np.asarray(c64, dtype=np.float64)
        self.c64.flags.writeable = False
        self.d = np.asarray(d, dtype=np.float64)
        self.n = int(self.d.shape[0])
        # corpus embeddings through the SAME forward cold-start rows use,
        # resident on the device
        self._emb = encoder.embed(self.c64, self.d, device=self.device)
        self._streams = None  # (probe, copy) streams on a card
        self.stale = np.zeros(self.n, dtype=bool)
        self.token = (str(token[0]), int(token[1]))
        self.cand_mult = int(cand_mult)
        self.shadow_every = max(int(shadow_every), 0)
        self.recall_floor = float(recall_floor)
        self.min_shadow = int(min_shadow)
        self.enabled = True
        # independent per-request reranks fan over a small pool (numpy
        # releases the GIL) instead of serializing on the completion
        # thread — the ANN rerank pool's sizing
        self.pool = ThreadPoolExecutor(
            max_workers=max(2, min(4, os.cpu_count() or 2)),
            thread_name_prefix="pathsim-learned-rerank",
        )
        self._lock = threading.Lock()
        self.shadow_n = 0
        self.recall_sum = 0.0
        self._since_shadow = 0
        # cold-start accounting: appended source rows (they land in
        # headroom slots, embedded from zero rows at setup — a delta
        # makes them real and stale) that absorb has not re-embedded
        # yet. seen is cumulative; pending drains to 0 per absorb.
        self.appended_seen = 0
        self._appended_pending = 0
        reg = get_registry()
        self._m_requests = reg.counter(
            "dpathsim_learned_requests_total",
            "topk requests answered through the learned path",
        ).labels()
        self._m_fallbacks = reg.counter(
            "dpathsim_learned_fallbacks_total",
            "learned-requested queries degraded to ann/exact, by reason",
        )
        self._m_recall = reg.gauge(
            "dpathsim_learned_recall_ratio",
            "measured shadow score-recall@k of the learned path vs the "
            "exact oracle (cumulative over the shadow samples)",
        ).labels()
        self._m_recall.set(1.0)
        self._m_cold = reg.gauge(
            "dpathsim_learned_cold_start_ratio",
            "fraction of appended (cold-start) rows the learned path "
            "can already answer (1.0 = every append absorbed)",
        ).labels()
        self._m_cold.set(1.0)
        self._m_probe = reg.histogram(
            "dpathsim_learned_probe_seconds",
            "learned candidate-generation (tower matmul) latency per "
            "batch",
        ).labels()
        self._m_rerank = reg.histogram(
            "dpathsim_learned_rerank_seconds",
            "exact candidate rerank latency per request",
        ).labels()

    # -- eligibility -------------------------------------------------------

    def peek(self, row: int) -> str | None:
        """Eligibility WITHOUT the counter side effect (the worker's
        response annotation and the flight recorder read this; only
        the answering path counts)."""
        with self._lock:
            enabled = self.enabled
        if not enabled:
            return "low_confidence"
        if not 0 <= row < self.n:
            return "uncovered"
        if self.stale[row]:
            return "stale"
        if self.d[row] <= 0:
            return "degenerate"
        return None

    def eligible(self, row: int) -> str | None:
        """None when the learned path may answer ``row``; otherwise
        the fallback reason (also counted)."""
        reason = self.peek(row)
        if reason is not None:
            self.note_fallback(reason)
        return reason

    def note_fallback(self, reason: str) -> None:
        self._m_fallbacks.inc(reason=reason)

    # -- probe + exact rerank ----------------------------------------------

    def tower_sims(self, rows: torch.Tensor) -> torch.Tensor:
        """Raw tower similarities [B, N] on the device, each query's own
        row at −inf — sealed: approximate score-scale numbers that must
        never leave learned/ unreranked."""
        sims = self._emb[rows] @ self._emb.T
        return sims.scatter_(
            1, rows[:, None], torch.full_like(sims[:, :1], float("-inf"))
        )

    def _top_c(self, rows: np.ndarray, c: int) -> torch.Tensor:
        r = torch.as_tensor(np.asarray(rows, dtype=np.int64)).to(self.device)
        order = torch.sort(self.tower_sims(r), dim=1, descending=True,
                           stable=True).indices
        return order[:, :c]

    def probe_batch(self, rows: np.ndarray, k: int) -> ProbeHandle:
        """Dispatcher-thread half: the tower product and the top-C pick
        for a padded batch whose largest request asks ``k``, queued on
        the state's probe stream (after what the caller's stream queued)
        with an event the completion thread's fetch waits on. On the CPU
        the ids are computed here."""
        c = min(_n_cand(k, self.cand_mult, self.n), self.n)
        if self.device.type != "cuda":
            return ProbeHandle(self._top_c(rows, c))
        from ..backends.torch_dense import PendingRows

        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        probe_stream, copy_stream = self._streams
        probe_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(probe_stream):
            ids = self._top_c(rows, c)
            event = torch.cuda.Event()
            event.record(probe_stream)
        return ProbeHandle(PendingRows(ids, event, copy_stream))

    def warm(self, buckets, k: int) -> None:
        """Drive the probe once per serving bucket (device buffers and
        library configurations set up), so the first real request of
        each bucket pays none of that."""
        for b in buckets:
            self.probe_batch(np.zeros(int(b), dtype=np.int64), k).fetch()

    def answer_from_handle(self, handle: ProbeHandle, b: int,
                           row: int, k: int):
        """Completion half for one request: its C = cand_mult·k best
        candidates from the fetched probe, exact-f64 reranked INSIDE
        this module — the only way an answer leaves the learned tier.
        Stale candidates are sound: only the QUERY row's freshness
        matters (an unaffected query row's entire exact score row is
        unchanged by the delta — the affected-rows superset guarantee),
        and a stale query never reaches here."""
        n_cand = min(_n_cand(k, self.cand_mult, self.n), self.n)
        cand = handle.fetch()[b, :n_cand]
        return self.rerank(row, cand[cand != row], k)

    def rerank(self, row: int, cand: np.ndarray, k: int):
        """Exact f64 top-k over the candidate set: integer counts from
        the C snapshot, shared normalize + tie order with the full
        exact path — bit-identical to the full-row answer whenever the
        true top-k is inside ``cand``."""
        cand = np.asarray(cand, dtype=np.int64)
        counts = self.c64[cand] @ self.c64[row]
        scores = pathsim.score_candidates(
            counts[None, :], np.asarray([self.d[row]]),
            self.d[cand][None, :],
        )
        vals, idxs = pathsim.topk_from_candidate_scores(
            scores, cand[None, :], k
        )
        return vals[0], idxs[0]

    # -- staleness + cold-start absorption ---------------------------------

    @property
    def stale_count(self) -> int:
        return int(self.stale.sum())

    @property
    def pending_appends(self) -> int:
        with self._lock:
            return self._appended_pending

    def mark_stale(self, rows: np.ndarray) -> int:
        """Fence delta-affected rows onto the fallback path until a
        refresh re-embeds them."""
        rows = np.asarray(rows)
        rows = rows[(rows >= 0) & (rows < self.n)]
        self.stale[rows] = True
        return int(rows.size)

    def note_appends(self, n_rows: int) -> None:
        """Record ``n_rows`` freshly appended source rows (cold-start
        authors): answered by counted fallback until :meth:`absorb`
        re-embeds them through the inductive encoder. Feeds the
        ``cold_start_answerable`` SLO gauge."""
        with self._lock:
            if n_rows > 0:
                self.appended_seen += int(n_rows)
                self._appended_pending += int(n_rows)
            pending = self._appended_pending
            seen = self.appended_seen
        self._m_cold.set(
            (seen - pending) / seen if seen else 1.0
        )

    def absorb(self, c_new: np.ndarray, d_new: np.ndarray,
               token: tuple[str, int]) -> dict:
        """Swap in the patched graph's C/d snapshot and re-embed ONLY
        the stale + appended rows through the inductive encoder — the
        O(Δ) cold-start path. Caller holds the service swap lock with
        the pipeline drained (no probe in flight reads the embeddings
        this replaces). Raises ``ValueError`` when the contraction width
        changed (new venue vocabulary → feature space moved; retrain),
        before any state moved: absorb is all-or-nothing."""
        c_new = np.asarray(c_new, dtype=np.float64)
        d_new = np.asarray(d_new, dtype=np.float64)
        n_new = int(d_new.shape[0])
        n_keep = min(self.n, n_new)
        need = np.flatnonzero(self.stale[:n_keep])
        appended = np.arange(n_keep, n_new, dtype=np.int64)
        rows = np.concatenate([need, appended])
        fresh = (
            self.encoder.embed(c_new[rows], d_new[rows], device=self.device)
            if rows.size else None
        )
        emb = torch.empty((n_new, self._emb.shape[1]),
                          dtype=self._emb.dtype, device=self.device)
        emb[:n_keep] = self._emb[:n_keep]
        if fresh is not None:
            emb[torch.as_tensor(rows).to(self.device)] = fresh
        c_new.flags.writeable = False
        self.c64 = c_new
        self.d = d_new
        self._emb = emb
        self.n = n_new
        self.stale = np.zeros(n_new, dtype=bool)
        self.token = (str(token[0]), int(token[1]))
        with self._lock:
            absorbed = self._appended_pending
            self._appended_pending = 0
        self.note_appends(0)  # republish the gauge (pending now 0)
        return {
            "re_embedded": int(rows.size),
            "appended": absorbed,
        }

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

    def record_shadow(self, got_vals, exact_vals, k: int) -> None:
        """Fold one shadow comparison into the confidence gate —
        SCORE recall@k, the ANN gate's metric and tie reasoning (a
        returned item whose exact score clears the oracle's k-th score
        is a hit; learned answers are exact-reranked, so the comparison
        is bit-meaningful)."""
        ev = np.asarray(exact_vals)
        gv = np.asarray(got_vals)
        want = ev[np.isfinite(ev)]
        if want.size == 0:
            return
        kth = want.min()
        got = gv[np.isfinite(gv)]
        recall = min(float((got >= kth).sum()) / float(want.size), 1.0)
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
                "learned_confidence_lost",
                recall=round(ratio, 4),
                floor=self.recall_floor,
                samples=samples,
            )

    def reset_confidence(self) -> None:
        """After an absorb the old shadow evidence describes a
        different tower state — start the gate fresh."""
        with self._lock:
            self.shadow_n = 0
            self.recall_sum = 0.0
            self._since_shadow = 0
            self.enabled = True
        self._m_recall.set(1.0)

    def close(self) -> None:
        self.pool.shutdown(wait=False)

    # -- accounting --------------------------------------------------------

    def count_answered(self) -> None:
        self._m_requests.inc()

    def observe_probe(self, seconds: float) -> None:
        self._m_probe.observe(seconds)

    def observe_rerank(self, seconds: float) -> None:
        self._m_rerank.observe(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            shadow_n = self.shadow_n
            ratio = self.recall_sum / shadow_n if shadow_n else None
            pending = self._appended_pending
            seen = self.appended_seen
            enabled = self.enabled
        return {
            "enabled": enabled,
            "dim": self.encoder.dim,
            "hidden": self.encoder.hidden,
            "cand_mult": self.cand_mult,
            "embedded_rows": self.n,
            "stale_rows": self.stale_count,
            "pending_appends": pending,
            "appended_seen": seen,
            "cold_start_ratio": (
                round((seen - pending) / seen, 6) if seen else 1.0
            ),
            "token": list(self.token),
            "shadow_samples": shadow_n,
            "shadow_recall": (
                round(ratio, 6) if ratio is not None else None
            ),
        }
