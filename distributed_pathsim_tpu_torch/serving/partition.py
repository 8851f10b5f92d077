"""PartitionService: one shard of a graph too big for one worker.

Where a replica (:class:`PathSimService`) holds the WHOLE graph and
answers whole queries, a partition worker holds a contiguous row-range
slice of the half-chain factor and answers *parts* of queries. The
distributed pairwise multiply is the row-separable identity ``M[s, j] =
C[s, :] · C[j, :]``: the owner of source row ``s`` serves the V-length
factor tile ``C[s, :]`` (``tile_pull``), every partition scores its OWN
rows ``j`` against that tile (``partial_topk`` / ``partial_scores``),
and the router merges with the candidate-restricted exact primitives
(``ops/pathsim.score_candidates`` + ``topk_from_candidate_scores``):
bit-identical to a single-host oracle, ties included, because every
number that enters the merge (pairwise counts, denominators) is an exact
integer in f64 and the selection order is the shared tie order at every
hop.

The window counts ``C_held[lo:hi] @ c_s`` run on the card in f64
(``ops/pathsim.device_counts``): the held window is mirrored there once
per ``update_seq`` (a routed delta drops every mirror). ``--platform
cpu`` is the host arm (numpy), never a fallback on the card. The
product is a plain f64 GEMM that the JAX package too computes outside
any Pallas kernel.

Wire ops served here (registered in ``PROTOCOL_OPS``; the request-id
dedup of the worker runtime covers the mutating ones):

- ``part_info``    — ownership map + per-held-range colsum contribution
- ``set_colsum``   — install (init) or patch (delta) the global column
                     sum ``g``; denominators ``d = C·g`` follow
- ``tile_pull``    — the source row's factor tile ``C[s, :]`` (sparse)
- ``partial_topk`` — this partition's top-k candidates for one range
- ``partial_scores`` — this partition's full score-row slice
- ``part_update``  — the ROUTED delta: stage the row-filtered edge
                     delta against the held slice (plan_delta's product
                     rule on the sliced HIN), return the Δcolsum
                     contribution the router aggregates
- ``resolve``      — label/id → global row (index spaces stay full)

Fencing state is per-partition: each held range carries a ``row_seq``
(bumped when a routed delta changes rows in that range) and the worker
carries a ``colsum_seq``/``update_seq`` (every delta moves the global
denominators). A partition that missed a broadcast lags the head and the
router fences and replays it in order.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future

import numpy as np

from ..backends.partition_factors import (
    FactorSlice,
    build_factor_slice,
    patch_factor_slice,
    range_colsums,
)
from ..data.partition import PartitionMap, filter_axis_edges, slice_hin
from ..obs.metrics import get_registry
from ..ops import pathsim
from ..utils.compile_counter import compiles_total
from ..utils.device import resolve_device
from ..utils.logging import runtime_event
from .cache import graph_fingerprint


class _NotReady(RuntimeError):
    """Raised for partial ops before the colsum exchange (or between a
    staged update and its seal). ``transient = True`` rides into the
    protocol error envelope so the router retries/fences instead of
    failing the query."""

    transient = True


class _NullCoalescer:
    """Shape-compatible stand-in: partition ops run synchronously on the
    read thread — there is no pipeline to drain."""

    depth = 0
    inflight = 0
    shed_count = 0
    batch_count = 0
    dispatched_requests = 0

    def drain(self) -> None:
        return None

    def close(self) -> None:
        return None


class _NullCache:
    hits = 0
    misses = 0


@dataclasses.dataclass
class PartitionConfig:
    """Partition-worker knobs (CLI-exposed via ``dpathsim-torch
    worker``)."""

    variant: str = "rowsum"
    k_default: int = 10
    # Resident layout of the held factor slice (the factor_format
    # tuning knob): None resolves through the registry with the
    # dense-slice "coo" behavior as the documented default.
    factor_format: str | None = None
    # where the window counts run: the card (default) or the host
    device: str | None = None


class _BackendShim:
    """What the worker loop's ready event and health payload read."""

    def __init__(self, name: str):
        self.name = name


class PartitionService:
    """One partition worker's warm state: the held factor slice, the
    global colsum once exchanged, and the per-range fencing seqs.

    Single-threaded by construction: every op runs synchronously on the
    worker loop's read thread (the scatter-gather concurrency lives at
    the router), so there is no lock and no torn state to guard.
    """

    def __init__(
        self,
        hin_full,
        metapath,
        part_index: int,
        n_parts: int,
        replication: int = 2,
        config: PartitionConfig | None = None,
    ):
        self.config = config or PartitionConfig()
        self.variant = self.config.variant
        if self.variant != "rowsum":
            # the diagonal variant's denominator is local (no colsum
            # exchange) — supportable, but untested; refuse loudly
            raise ValueError(
                "partition mode currently serves variant='rowsum' "
                f"(got {self.variant!r})"
            )
        self.metapath = metapath
        self.node_type = metapath.source_type
        n = hin_full.type_size(self.node_type)
        self.pmap = PartitionMap(n=n, p=int(n_parts))
        self.part_index = int(part_index)
        self.replication = max(1, min(int(replication), self.pmap.p))
        self.held = self.pmap.held_by(self.part_index, self.replication)
        # fingerprint the FULL graph before slicing: every partition of
        # the same dataset agrees, which is the router's startup check
        self._base_fp = graph_fingerprint(hin_full)
        self._fp = self._base_fp
        self.hin = slice_hin(
            hin_full, self.node_type,
            [self.pmap.range_of(g) for g in self.held],
        )
        self.index = self.hin.indices[self.node_type]
        fmt = self.config.factor_format
        if fmt is None:
            from .. import tuning

            fmt = str(tuning.choose(
                "factor_format", n=n, default="coo",
            ))
        self.factor_format = fmt
        self.fs: FactorSlice = build_factor_slice(
            self.hin, metapath, self.pmap, self.held,
            factor_format=fmt,
        )
        self.n = self.pmap.n
        # fencing state: per-held-range row epochs + the global
        # denominator epoch (every routed delta advances colsum_seq;
        # row_seq[g] advances only when rows in g re-encode)
        self.row_seq = {g: 0 for g in self.held}
        self.colsum_seq = 0
        self.update_seq = 0
        self._g: np.ndarray | None = None       # global colsum [V]
        self._d_held: np.ndarray | None = None  # denominators, held rows
        # a part_update staged but not yet sealed: {seq, attempt, plan}.
        # Staging mutates NOTHING (prepare/commit): the patch, the hin
        # adoption, and the denominator update all happen at the seal,
        # so an aborted attempt (the router found a range with no live
        # current holder) is discarded for free, and a superseding
        # attempt of the same seq simply replaces the stage.
        self._staged: dict | None = None
        self.device = resolve_device(self.config.device)
        self.coalescer = _NullCoalescer()
        self.result_cache = _NullCache()
        self.tile_cache = _NullCache()
        self.backend = _BackendShim(f"partition[{self.device.type}]")
        reg = get_registry()
        self._m_partial = reg.histogram(
            "dpathsim_partition_partial_seconds",
            "partition-local partial op wall time by op",
        )
        self._m_score_backend = reg.counter(
            "dpathsim_partition_score_backend_total",
            "partial-op scorings by execution backend (cuda = the card's "
            "f64 window product; numpy = the host arm of --platform cpu)",
        )
        # the window counts run on the card in f64 unless the worker was
        # asked for the host: both arms give identical bytes (exact
        # integers in f64, score_candidates is elementwise)
        self._win_dev = {}      # (lo, hi) → device mirror of the window
        self._win_seq = None    # update_seq the mirrors were cut at
        reg.gauge(
            "dpathsim_partition_rows_held",
            "factor rows resident on this partition worker",
        ).labels(
            ranges="+".join(str(g) for g in self.held)
        ).set(float(self.fs.n_held))
        reg.gauge(
            "dpathsim_factor_bytes",
            "resident half-chain factor bytes by layout format",
        ).labels(format=self.factor_format).set(
            float(self.fs.factor_bytes())
        )
        runtime_event(
            "partition_ready",
            part_index=self.part_index, partitions=self.pmap.p,
            replication=self.replication, held=list(self.held),
            rows_held=self.fs.n_held, n=self.n, v=self.fs.v,
            base_fp=self._base_fp,
        )

    # -- identity / protocol surface ---------------------------------------

    @property
    def consistency_token(self) -> tuple[str, int]:
        return (self._base_fp, self.update_seq)

    @property
    def ready(self) -> bool:
        return self._d_held is not None

    def resolve(self, source: str | None = None,
                source_id: str | None = None,
                row: int | None = None) -> int:
        if row is not None:
            if not 0 <= int(row) < self.n:
                raise KeyError(f"row {row} out of range [0, {self.n})")
            return int(row)
        return self.hin.resolve_source(
            self.node_type, label=source, node_id=source_id
        )

    def _ident(self, i: int) -> tuple[str, str]:
        if i < len(self.index.ids):
            return self.index.ids[i], self.index.labels[i]
        return f"{self.node_type}_{i}", f"{self.node_type}_{i}"

    def ann_fallback_reason(self, row: int, mode=None):
        return None

    def submit_topk(self, row: int, k: int | None = None, mode=None):
        """Partition workers answer ``partial_topk``, never whole
        queries — a stray replicate-mode dispatch fails cleanly."""
        fut: Future = Future()
        fut.set_exception(RuntimeError(
            "partition worker serves partial_topk, not topk — route "
            "through `dpathsim-torch router --mode partition`"
        ))
        return fut

    def health(self) -> dict:
        return {
            "ok": True,
            "n": self.n,
            "queue_depth": 0,
            "inflight": 0,
            "shed": 0,
            "base_fp": self._base_fp,
            "delta_seq": self.update_seq,
            "fingerprint": self._fp,
            "backend": self.backend.name,
            "index": None,
            "partition": self.partition_state(),
            "compiles": compiles_total(),
        }

    def partition_state(self) -> dict:
        return {
            "index": self.part_index,
            "partitions": self.pmap.p,
            "replication": self.replication,
            "held": list(self.held),
            "ranges": {
                str(g): list(self.pmap.range_of(g)) for g in self.held
            },
            "rows_held": self.fs.n_held,
            "row_seq": {str(g): self.row_seq[g] for g in self.held},
            "colsum_seq": self.colsum_seq,
            "update_seq": self.update_seq,
            "ready": self.ready,
        }

    def stats(self) -> dict:
        return {
            "n": self.n,
            "metapath": self.metapath.name,
            "variant": self.variant,
            "backend": self.backend.name,
            "fingerprint": self._fp,
            "partition": self.partition_state(),
            "factor_bytes": self.fs.factor_bytes(),
            "factor_format": self.factor_format,
            "obs": {
                "metrics": get_registry().enabled,
            },
        }

    def invalidate(self) -> None:
        return None  # no cache tiers on a partition worker

    def close(self) -> None:
        return None

    # -- colsum exchange ----------------------------------------------------

    def part_info(self, req: dict) -> dict:
        """Ownership map + this worker's colsum contribution per held
        range (exact integer sums — any holder's contribution for a
        range is bit-identical to any other's)."""
        return {
            "partition": self.partition_state(),
            "v": self.fs.v,
            "colsum": {
                str(g): payload
                for g, payload in range_colsums(self.fs, self.held).items()
            },
        }

    def set_colsum(self, req: dict) -> dict:
        """Install (``mode: "init"``), seal (``mode: "delta"``), or
        abort (``mode: "abort"``) — the commit side of the two-phase
        routed delta. A seal applies the staged plan atomically: patch
        the factor slice, adopt the new HIN, patch the colsum, then
        the denominators — unaffected rows get the incremental
        ``d += C·Δg`` (exact: integer dot), re-encoded rows a full
        ``d[i] = C[i]·g_new``. An abort just drops the stage (nothing
        was mutated at stage time)."""
        mode = req.get("mode", "init")
        cols = np.asarray(req.get("cols") or [], dtype=np.int64)
        vals = np.asarray(req.get("vals") or [], dtype=np.float64)
        if mode == "init":
            g = np.zeros(self.fs.v, dtype=np.float64)
            g[cols] = vals
            self._g = g
            self._d_held = self.fs.matvec(g)
            runtime_event(
                "partition_colsum_init", part_index=self.part_index,
                nnz=int(cols.shape[0]), echo=False,
            )
            return {"ready": True, "colsum_seq": self.colsum_seq}
        seq = int(req.get("seq") or 0)
        attempt = int(req.get("attempt") or 0)
        if mode == "abort":
            if self._staged is not None and (
                self._staged["seq"] == seq
                and self._staged["attempt"] == attempt
            ):
                self._staged = None
                runtime_event(
                    "partition_update_aborted",
                    part_index=self.part_index, seq=seq,
                    attempt=attempt, echo=False,
                )
            # an already-dropped/superseded stage aborts idempotently
            return {"aborted": seq, "attempt": attempt}
        if mode != "delta":
            raise ValueError(f"unknown set_colsum mode {mode!r}")
        if self._g is None or self._d_held is None:
            raise ValueError("set_colsum delta before init")
        if self._staged is None or self._staged["seq"] != seq or (
            self._staged["attempt"] != attempt
        ):
            raise ValueError(
                f"set_colsum seq {seq}/attempt {attempt} does not seal "
                "the staged update (staged: "
                f"{None if self._staged is None else (self._staged['seq'], self._staged['attempt'])})"
            )
        plan = self._staged["plan"]
        changed = patch_factor_slice(self.fs, plan.delta_c, self.n)
        self.hin = plan.hin_new
        self.index = self.hin.indices[self.node_type]
        self._fp = plan.fingerprint
        dg = np.zeros(self.fs.v, dtype=np.float64)
        dg[cols] = vals
        self._g = self._g + dg
        if cols.shape[0]:
            self._d_held = self._d_held + self.fs.matvec(dg)
        if changed.shape[0]:
            slots = self.fs.held_slot_of[changed]
            self._d_held[slots] = self.fs.rows_matvec(slots, self._g)
            for g_idx in sorted({
                self.pmap.owner_of(int(r)) for r in changed
            }):
                if g_idx in self.row_seq:
                    self.row_seq[g_idx] += 1
        self._staged = None
        self.colsum_seq = seq
        self.update_seq = seq
        # packed slices may re-bucket patched chunks — keep the
        # memory-headroom gauge current
        get_registry().gauge(
            "dpathsim_factor_bytes",
            "resident half-chain factor bytes by layout format",
        ).labels(format=self.factor_format).set(
            float(self.fs.factor_bytes())
        )
        runtime_event(
            "partition_update_sealed", part_index=self.part_index,
            seq=seq, re_encoded=int(changed.shape[0]), echo=False,
        )
        return {
            "sealed": seq,
            "row_seq": {str(g): self.row_seq[g] for g in self.held},
            "colsum_seq": self.colsum_seq,
        }

    # -- the distributed half-chain multiply --------------------------------

    def tile_pull(self, req: dict) -> dict:
        """The source row's factor tile ``C[s, :]`` (sparse) plus its
        denominator — the boundary exchange every peer partition scores
        against. A pull for a row outside the held ranges redirects
        (the router re-aims at the owner)."""
        row = self.resolve(
            source=req.get("source"), source_id=req.get("source_id"),
            row=req.get("row"),
        )
        if not self.fs.holds(row):
            return {
                "wrong_owner": True, "row": int(row),
                "owner": self.pmap.owner_of(row),
            }
        self._require_ready()
        slot = int(self.fs.held_slot_of[row])
        crow = self.fs.row_dense(slot)
        nz = np.flatnonzero(crow)
        return {
            "row": int(row),
            "cols": [int(c) for c in nz],
            "vals": [float(crow[c]) for c in nz],
            "d_source": float(self._d_held[slot]),
            "seq": self.update_seq,
        }

    def _require_ready(self) -> None:
        if not self.ready:
            # transient: the router retries elsewhere / after catch-up
            raise _NotReady(
                "partition awaiting colsum exchange / update seal"
            )

    def _window(self, g: int):
        if g not in self.fs.range_slots:
            raise KeyError(
                f"partition worker p{self.part_index} does not hold "
                f"range {g} (held: {list(self.held)})"
            )
        lo_slot, hi_slot = self.fs.range_slots[g]
        glo, ghi = self.pmap.range_of(g)
        return lo_slot, hi_slot, glo, ghi

    def _source_tile(self, req: dict):
        cols = np.asarray(req.get("cols") or [], dtype=np.int64)
        vals = np.asarray(req.get("vals") or [], dtype=np.float64)
        c_s = np.zeros(self.fs.v, dtype=np.float64)
        c_s[cols] = vals
        return c_s, float(req.get("d_source") or 0.0)

    def _window_counts(
        self, lo_slot: int, hi_slot: int, c_s: np.ndarray
    ) -> np.ndarray:
        """``C_held[lo:hi] @ c_s`` — exact integer-valued f64 counts. On
        the card the held window is mirrored there once per update_seq
        (a sealed delta drops every mirror) and the product is an f64
        GEMM (``ops/pathsim.device_counts``), bit-identical to the host
        arm because the products and sums are exact integers in f64
        under any association order."""
        if self.device.type != "cuda":
            self._m_score_backend.inc(backend="numpy")
            return self.fs.window_dense(lo_slot, hi_slot) @ c_s
        import torch

        if self._win_seq != self.update_seq:
            self._win_dev.clear()
            self._win_seq = self.update_seq
        dev = self._win_dev.get((lo_slot, hi_slot))
        if dev is None:
            dev = torch.as_tensor(
                self.fs.window_dense(lo_slot, hi_slot), dtype=torch.float64
            ).to(self.device)
            self._win_dev[(lo_slot, hi_slot)] = dev
        self._m_score_backend.inc(backend="cuda")
        return pathsim.device_counts(c_s[None, :], dev.T)[0]

    def partial_topk(self, req: dict) -> dict:
        """This partition's top-k candidates for range ``g``: exact
        integer pairwise counts against the source tile, f64 scores via
        the shared candidate primitive, local top-k in the oracle tie
        order. Global top-k ⊆ union of per-range top-k (the order is
        total), so the router's merge over these candidates is exact."""
        t0 = time.perf_counter()
        self._require_ready()
        g = int(req.get("range") or 0)
        k = int(req.get("k") or self.config.k_default)
        row = int(req.get("row") or 0)
        lo_slot, hi_slot, glo, ghi = self._window(g)
        if hi_slot == lo_slot:
            return {"range": g, "cands": [], "seq": self.update_seq}
        c_s, d_source = self._source_tile(req)
        d_win = self._d_held[lo_slot:hi_slot]
        # exact integer-valued f64 products (the card's f64 GEMM)
        m = self._window_counts(lo_slot, hi_slot, c_s)
        scores = pathsim.score_candidates(
            m[None, :], np.asarray([d_source]), d_win[None, :], xp=np
        )
        cols_global = np.arange(glo, ghi, dtype=np.int64)
        if glo <= row < ghi:
            cols_global = cols_global.copy()
            cols_global[row - glo] = -1  # self pair never ranks
        vals, idxs = pathsim.topk_from_candidate_scores(
            scores, cols_global[None, :], min(k, max(ghi - glo, 1))
        )
        cands = []
        for v, j in zip(vals[0], idxs[0]):
            if not np.isfinite(v):
                continue
            i_id, lab = self._ident(int(j))
            cands.append({
                "col": int(j),
                "m": float(m[int(j) - glo]),
                "d": float(d_win[int(j) - glo]),
                "id": i_id,
                "label": lab,
            })
        self._m_partial.observe(
            time.perf_counter() - t0, op="partial_topk"
        )
        return {"range": g, "cands": cands, "seq": self.update_seq}

    def partial_scores(self, req: dict) -> dict:
        """The full count/denominator slice for range ``g`` — the
        ``scores`` op's partition share (self pair included, exactly as
        the single-host score row has it)."""
        t0 = time.perf_counter()
        self._require_ready()
        g = int(req.get("range") or 0)
        lo_slot, hi_slot, glo, ghi = self._window(g)
        c_s, _ = self._source_tile(req)
        m = self._window_counts(lo_slot, hi_slot, c_s)
        d_win = self._d_held[lo_slot:hi_slot]
        self._m_partial.observe(
            time.perf_counter() - t0, op="partial_scores"
        )
        return {
            "range": g,
            "lo": glo,
            "counts": [float(x) for x in m],
            "denoms": [float(x) for x in d_win],
            "seq": self.update_seq,
        }

    # -- routed deltas -------------------------------------------------------

    def part_update(self, req: dict) -> dict:
        """Phase 1 (PREPARE) of a routed delta: plan the row-filtered
        edge delta against the held slice (plan_delta's product rule on
        the sliced HIN — its ΔC support is confined to held rows by
        construction, so the eventual patch is O(Δ)), stage the plan
        WITHOUT mutating anything, and return the Δcolsum contribution
        per held range for the router to aggregate. Phase 2 commits
        (``set_colsum`` mode=delta) or discards (mode=abort — e.g. the
        router found an affected range with no live current holder,
        where sealing would silently lose that range's contribution).
        A new attempt of the same seq supersedes a stale stage, so a
        lost abort self-heals."""
        from ..data.delta import delta_from_records, plan_delta

        if req.get("add_nodes"):
            raise ValueError(
                "partition mode routes edge deltas only; node appends "
                "re-shape the ownership map — reload the fleet"
            )
        seq = int(req.get("seq") or 0)
        attempt = int(req.get("attempt") or 0)
        if seq != self.update_seq + 1:
            raise ValueError(
                f"part_update seq {seq} out of order "
                f"(applied: {self.update_seq})"
            )
        add, remove = filter_axis_edges(
            self.hin, self.node_type,
            [self.pmap.range_of(g) for g in self.held],
            add_edges=req.get("add_edges") or (),
            remove_edges=req.get("remove_edges") or (),
        )
        delta = delta_from_records(
            self.hin, add_edges=add, remove_edges=remove
        )
        plan = plan_delta(
            self.hin, delta, self.metapath, max_delta_fraction=1.0
        )
        if plan.fallback:
            raise ValueError(
                f"partition delta needs a rebuild ({plan.reason}) — "
                "unsupported in partition mode"
            )
        dc_rows = plan.delta_c.rows.astype(np.int64)
        contrib: dict[str, dict] = {}
        affected: set[int] = set()
        for g in self.held:
            glo, ghi = self.pmap.range_of(g)
            mask = (dc_rows >= glo) & (dc_rows < ghi)
            if not mask.any():
                continue
            affected.add(g)
            dg = np.zeros(self.fs.v, dtype=np.float64)
            np.add.at(
                dg, plan.delta_c.cols[mask],
                plan.delta_c.weights[mask].astype(np.float64),
            )
            nz = np.flatnonzero(dg)
            if nz.shape[0]:
                contrib[str(g)] = {
                    "cols": [int(c) for c in nz],
                    "vals": [float(dg[c]) for c in nz],
                }
        self._staged = {"seq": seq, "attempt": attempt, "plan": plan}
        runtime_event(
            "partition_update_staged", part_index=self.part_index,
            seq=seq, attempt=attempt,
            edge_changes=plan.n_edge_changes,
            ranges=sorted(affected), echo=False,
        )
        return {
            "staged": seq,
            "attempt": attempt,
            "contrib": contrib,
            "re_encoded": int(
                np.unique(dc_rows[dc_rows < self.n]).shape[0]
            ),
            "affected_ranges": sorted(affected),
            "held": list(self.held),
        }
