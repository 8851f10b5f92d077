"""The PathSim driver: single-source, rank-all and all-pairs runs over
any backend.

Reference parity (components C4 + C5, ``DPathSim_APVPA.py:9-68``): the
driver walks targets in node file order (the reference's dict insertion
order), emits the exact reference log grammar, and stores scores in an
id-keyed dict — but where the reference issues ``2N-1`` distributed joins,
all counts here come from at most two device computations (row sums +
source row), so "per-stage time" collapses to formatting.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import resilience
from .backends.base import PathSimBackend
from .obs.trace import get_tracer
from .utils.logging import RunLogger
from .utils.profiling import StageTimer


def _format_count(x: float) -> int:
    """Counts are exact integers carried in floats; render like the
    reference's ``int(total_path)``."""
    return int(round(float(x)))


@dataclasses.dataclass
class SingleSourceResult:
    source_id: str
    source_label: str
    scores: dict[str, float]  # target node id → score, target order preserved
    global_walks: dict[str, int]
    pairwise_walks: dict[str, int]
    elapsed_s: float


class PathSimDriver:
    """Runs PathSim over a prepared backend.

    ``node_type`` is the metapath's endpoint type (author for APVPA).
    """

    def __init__(self, backend: PathSimBackend, variant: str = "rowsum"):
        self.backend = backend
        self.variant = variant
        self.hin = backend.hin
        self.node_type = backend.metapath.source_type
        self.index = self.hin.indices[self.node_type]

    def run_single_source(
        self,
        source: str,
        by_label: bool = True,
        logger: RunLogger | None = None,
    ) -> SingleSourceResult:
        """The reference's ``run()``: one source vs all other nodes of the
        endpoint type, with per-stage reference-grammar logging."""
        # Root span for the whole run: the StageTimer stages inside
        # nest under it, so a --trace-out dump shows one tree per query.
        with get_tracer().span(
            "driver.run_single_source", source=str(source)
        ):
            return self._run_single_source(source, by_label, logger)

    def _run_single_source(
        self,
        source: str,
        by_label: bool,
        logger: RunLogger | None,
    ) -> SingleSourceResult:
        logger = logger or RunLogger(output_path=None, echo=False)
        timer = StageTimer(logger, device=getattr(self.backend, "device",
                                                  None))
        t0 = time.perf_counter()
        # Reference parity: the reference starts its overall clock when
        # the run begins (DPathSim_APVPA.py:26), not when the log file is
        # opened — a logger constructed before bootstrap must not fold
        # load/encode time into "***Overall done in:".
        logger.overall_start = t0

        source_index = self.hin.resolve_source(
            self.node_type,
            label=source if by_label else None,
            node_id=None if by_label else source,
        )

        # The reference's 2N-1 joins collapse to two device computations
        # (denominators + the source's pairwise row) and host formatting;
        # the stages show where the time goes. Both device computations
        # sit behind the device_execute seam: a transient dispatch
        # failure is retried rather than killing the run.
        with timer.stage("device_denominators"):
            d = resilience.resilient_call(
                "device_execute",
                lambda: self.backend._denominators(self.variant),
            )
        with timer.stage("device_pairwise_row"):
            row = resilience.resilient_call(
                "device_execute",
                lambda: self.backend.pairwise_row(source_index),
            )
        source_label = self.index.labels[source_index]
        source_id = self.index.ids[source_index]

        logger.source_global_walk(_format_count(d[source_index]))
        logger.metric(
            event="source_global_walk",
            source=source_id,
            count=_format_count(d[source_index]),
        )

        scores: dict[str, float] = {}
        global_walks: dict[str, int] = {}
        pairwise_walks: dict[str, int] = {}
        n = self.index.size
        d_src = float(d[source_index])
        with timer.stage("emit_log"):
            for t in range(n):
                if t == source_index:
                    continue
                stage_t0 = time.perf_counter()
                target_id = self.index.ids[t]
                pw = _format_count(row[t])
                gw = _format_count(d[t])
                denom = d_src + float(d[t])
                score = 2.0 * float(row[t]) / denom if denom > 0 else 0.0

                logger.pairwise_walk(target_id, pw)
                logger.target_global_walk(gw)
                logger.sim_score(source_label, self.index.labels[t], score)
                logger.stage_done(time.perf_counter() - stage_t0)

                scores[target_id] = score
                global_walks[target_id] = gw
                pairwise_walks[target_id] = pw

        logger.overall_done()
        return SingleSourceResult(
            source_id=source_id,
            source_label=source_label,
            scores=scores,
            global_walks=global_walks,
            pairwise_walks=pairwise_walks,
            elapsed_s=time.perf_counter() - t0,
        )

    def run_all_pairs(self) -> np.ndarray:
        """All-pairs score matrix — the capability the reference
        extrapolates to ~24 h of joins (SURVEY.md §6)."""
        with get_tracer().span("driver.run_all_pairs", n=self.index.size):
            return resilience.resilient_call(
                "device_execute",
                lambda: self.backend.all_pairs_scores(variant=self.variant),
            )

    def rank_all(self, k: int = 10, checkpoint_dir: str | None = None):
        """Per-source top-k ranking for EVERY node: (values [N, k] f64,
        indices [N, k] int64), self-pairs excluded.

        This is the batched generalization of the reference's whole
        program (one source against all targets, ``DPathSim_APVPA.py:
        28-68``) to all sources at once. Dispatch, best first: the
        streaming row-tiled top-k (torch-sparse; checkpoint/resume,
        never materializes N×N), the backend's on-device top-k (torch:
        the CUDA top-k kernels), else the dense score matrix + stable
        argsort (any backend).
        """
        with get_tracer().span("driver.rank_all", k=k):
            return self._rank_all(k, checkpoint_dir)

    def _rank_all(self, k: int, checkpoint_dir: str | None):
        b = self.backend
        if hasattr(b, "topk_scores"):
            vals, idxs = b.topk_scores(
                k=k, variant=self.variant, checkpoint_dir=checkpoint_dir
            )
            return self._to_f64(vals, idxs)
        if checkpoint_dir is not None:
            raise ValueError(
                "checkpointed ranking requires a streaming backend "
                "(torch-sparse)"
            )
        if hasattr(b, "topk") and b.metapath.is_symmetric:
            vals, idxs = resilience.resilient_call(
                "device_execute",
                lambda: b.topk(k=k, mask_self=True, variant=self.variant),
            )
            return self._to_f64(vals, idxs)
        scores = np.array(
            resilience.resilient_call(
                "device_execute",
                lambda: b.all_pairs_scores(variant=self.variant),
            ),
            dtype=np.float64,
        )
        np.fill_diagonal(scores, -np.inf)
        idxs = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        vals = np.take_along_axis(scores, idxs, axis=1)
        return vals, idxs.astype(np.int64)

    def _to_f64(self, vals, idxs):
        """A backend's top-k as rank_all hands it over: values f64,
        indices int64 (no copy where they already are: the exact
        instances' f64 values pass as they are, and the span records 0
        bytes for them)."""
        with get_tracer().span(
            "driver.to_f64", device=getattr(self.backend, "device", None)
        ) as span:
            out = np.asarray(vals, dtype=np.float64), np.asarray(
                idxs, dtype=np.int64)
            if span is not None:  # the bytes of the casts made
                span.args["bytes"] = sum(
                    new.nbytes for new, old in zip(out, (vals, idxs))
                    if new is not old)
        return out

    def write_ranking(self, path: str, vals: np.ndarray, idxs: np.ndarray):
        """TSV dump of a rank_all result: source_id, rank, target_id,
        score — the machine-readable analog of the reference's log."""
        with open(path, "w", encoding="utf-8") as f:
            f.write("source_id\trank\ttarget_id\tscore\n")
            for s in range(vals.shape[0]):
                for r in range(vals.shape[1]):
                    if not np.isfinite(vals[s, r]):
                        continue  # k exceeded the real candidate count
                    f.write(
                        f"{self.index.ids[s]}\t{r + 1}\t"
                        f"{self.index.ids[int(idxs[s, r])]}\t"
                        f"{vals[s, r]:.17g}\n"
                    )

    def top_k(self, source: str, k: int = 10, by_label: bool = True):
        """Ranked similar nodes — similarity *search*, the purpose PathSim
        serves in Sun et al. Routed through the backend's ``topk_row``
        primitive (exact f64 scores, oracle tie order)."""
        res_index = (
            self.hin.find_index_by_label(self.node_type, source)
            if by_label
            else self.index.index_of.get(source)
        )
        if res_index is None:
            raise KeyError(f"unknown {self.node_type} {source!r}")
        vals, idxs = self.backend.topk_row(res_index, k=k, variant=self.variant)
        return [
            (self.index.ids[int(i)], self.index.labels[int(i)], float(v))
            for v, i in zip(vals, idxs)
            if np.isfinite(v)
        ]
