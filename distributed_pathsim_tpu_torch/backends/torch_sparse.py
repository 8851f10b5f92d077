"""Streaming sparse backend on torch (BASELINE.json config 5 path).

The port of the JAX package's ``jax-sparse`` backend. The half-chain
factor C is folded sparsely on the host (ops/planner.py) and held there
as COO or, behind the ``factor_format`` knob, as a compressed
``blocked`` / ``bitpacked`` factor (ops/packed.py) whose chunks are the
row tiles; the device holds row tiles of C, densified on demand
(ops/sparse.TiledHalfChain), or the whole dense C when it fits
:attr:`TorchSparseBackend._DENSE_C_DEVICE_BUDGET`. Rank-all
(:meth:`TorchSparseBackend.topk_scores`) streams row tiles: each row
tile's top-k against every column, never more than one row tile's
candidates on the device, only the [tile, k] winners fetched, each
completed tile checkpointable.

A row tile takes one of three arms, as in the JAX package: K3 + pass 2
(ops/cuda_kernels.fused_topk_twopass_rect) on the card for f32, k < 16
and a candidate buffer within budget; the scanned fold (a loop of tile
GEMMs + sorts over the device-resident dense C) otherwise; the per-tile
fold over the LRU of densified tiles when the dense C is over budget.
``compute_path`` in the checkpoint identity records which arm ran.
``topk_scores(symmetric=True)`` runs the JAX package's symmetric
half-sweep instead (ops/sparse.stream_merge_topk_pair): each (i, j ≥ i)
tile pair is scored once and folded into both row blocks, resumable
from rolling ``sym_partials_after_{i}`` snapshots; its checkpoints
(``stream-topk-v3-sym``) never mix with the full sweep's.

The sweep has the JAX package's resilience seams: each row tile's launch
is one ``tile_execute`` attempt (retried alone under the retry policy;
the tiles already in flight are untouched), a preemption request is
honored between tiles by flushing every finished tile through the
``CheckpointManager`` and raising ``Preempted`` (the CLI exits 75), and
each checkpoint write retries transient I/O faults.

The tile height, the scatter-pad floor and the factor format resolve
through the tuning registry (``sparse_tile_rows``, default 4096;
``sparse_nnz_floor``, default 1; ``factor_format``, ``coo``), once at
build and pinned for the backend's life: a delta patches the same
representation (``packed.patch_factor`` for a packed one). The gauge
``dpathsim_factor_bytes{format}`` reports the resident factor bytes.

Past the f32 exact-integer range (row sums ≥ 2^24) with
``exact_counts=True`` the f32 pass runs as a candidate prefilter and an
exact f64 host rescore (with a per-row soundness certificate and a
full-row fallback) reduces the candidates to the exact top-k.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import resilience
from ..obs.trace import get_tracer
from ..ops import chain, planner
from ..ops import cuda_kernels as ck
from ..ops import packed as pkd
from ..ops import sparse as sp
from ..ops.metapath import MetaPath
from ..resilience.preemption import handler as _preemption
from ..utils.device import resolve_device
from .base import PathSimBackend, register_backend

# Refuse to densify all-pairs outputs beyond this many entries (16k×16k
# f64 ≈ 2 GB); larger graphs must use the streaming top-k path.
_DENSE_M_MAX_ENTRIES = 1 << 28


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


@register_backend("torch-sparse")
class TorchSparseBackend(PathSimBackend):
    # Dense C on the device enables the scanned pass and K3 (one column
    # sweep per row tile instead of n_tiles² tile dispatches). The JAX
    # package allows a quarter of a 16 GB v5e (4 GB); a quarter of an
    # 80 GB H100 is 20 GB: ~80M authors at V = 64 in f32.
    _DENSE_C_DEVICE_BUDGET = 20 << 30
    # In-flight row tiles: one fetching, one computing, one queued.
    _PIPELINE_DEPTH = 3

    def __init__(
        self,
        hin,
        metapath: MetaPath,
        tile_rows: int | None = None,
        dtype=torch.float32,
        device=None,
        exact_counts: bool = True,
        dense_c_budget_bytes: int | None = None,
        rect_kernel: bool | None = None,
        factor_format: str | None = None,
        **options,
    ):
        """``exact_counts=True`` (default) delivers exact integer counts
        and bit-exact-vs-f64 scores at any scale: below 2^24 the f32
        pass is already exact; past it the two-phase rescore takes over
        (see :meth:`_exact_topk_rescore`). ``exact_counts=False`` (the
        CLI's ``--approx``) waives that: scores are scale-invariant in
        C, so f32 rounding costs only ~√V·2⁻²⁴ relative; rankings may
        swap near-exact ties.

        ``rect_kernel``: None runs K3 on the card and the scanned fold on
        the CPU (as the JAX package does on its CPU); True forces K3's
        arm (its plain version on the CPU); False forces the fold."""
        self.device = resolve_device(device)
        super().__init__(hin, metapath, **options)
        self.options = {
            **options, "tile_rows": tile_rows, "dtype": dtype,
            "device": self.device, "exact_counts": exact_counts,
            "dense_c_budget_bytes": dense_c_budget_bytes,
            "rect_kernel": rect_kernel,
        }
        if not metapath.is_symmetric:
            raise ValueError("torch-sparse requires a symmetric metapath")
        if self.device.type == "cuda":
            ck.check_true_f32()
        self.exact_counts = exact_counts
        self._dtype = dtype
        self._dense_c_budget = (
            self._DENSE_C_DEVICE_BUDGET
            if dense_c_budget_bytes is None
            else int(dense_c_budget_bytes)
        )
        self._rect_kernel = rect_kernel
        coo = planner.fold_half(hin, metapath, memo=self._subchain_memo,
                                plan=self.plan)
        # Knobs resolved ONCE, keyed on the folded factor's real (N, V,
        # density), and pinned: a delta rebind reuses them, so tile
        # shapes stay stable across updates.
        from .. import tuning

        shape = dict(n=coo.shape[0], v=coo.shape[1],
                     nnz=int(coo.rows.shape[0]), dtype=_dtype_name(dtype))
        if tile_rows is None:
            tile_rows = tuning.choose("sparse_tile_rows", default=4096,
                                      **shape)
        self._tile_rows_req = int(tile_rows)
        self._nnz_floor_req = int(
            tuning.choose("sparse_nnz_floor", default=1, **shape))
        if factor_format is None:
            factor_format = str(
                tuning.choose("factor_format", default="coo", **shape))
        if factor_format not in pkd.FACTOR_FORMATS:
            raise ValueError(
                f"unknown factor_format {factor_format!r}; choose from "
                f"{pkd.FACTOR_FORMATS}"
            )
        self._factor_format = factor_format
        self._bind_factor(coo)

    def _bind_factor(self, factor) -> None:
        """Bind the half-chain factor: a COO (packed here when the
        ``factor_format`` knob says so) or an already-patched packed one
        from the delta path. Overflow-mode detection, tiling, cache
        reset. The chunk height is the tile height, so every tile decode
        touches exactly its own chunks."""
        self.n = self.hin.type_size(self.metapath.source_type)
        tile_rows_eff = min(self._tile_rows_req, max(int(factor.shape[0]), 8))
        if not pkd.is_packed(factor) and self._factor_format != "coo":
            factor = pkd.make_factor(factor, self._factor_format,
                                     chunk_rows=tile_rows_eff)
        self._factor = factor
        self._c = None if pkd.is_packed(factor) else factor
        # Overflow detection (cheap bound, then the tight per-row check):
        # the outcome is a MODE, not a refusal. d_i >= M[i,j] >= every
        # partial sum (non-negative data), so max rowsum < 2^24 proves
        # the whole f32 pipeline exact; past it the rescore restores it.
        self._exact_rescore = False
        self._host_rowsums = None
        if self.exact_counts and chain._is_float32(self._dtype):
            colsum = np.asarray(pkd.factor_colsum(factor), dtype=np.float64)
            if float((colsum**2).sum()) >= chain.F32_EXACT_INT_MAX:
                rs = pkd.factor_rowsums_weighted(factor, colsum)[: self.n]
                if rs.max(initial=0.0) >= chain.F32_EXACT_INT_MAX:
                    self._exact_rescore = True
                    self._host_rowsums = rs
        self.tiled = sp.TiledHalfChain(
            factor,
            tile_rows=tile_rows_eff,
            dtype=self._dtype,
            device=self.device,
            # in rescore mode the f32 tiles are a prefilter by design;
            # the tiled guard would refuse what the rescore phase fixes
            exact_counts=self.exact_counts and not self._exact_rescore,
            nnz_bucket_floor=self._nnz_floor_req,
        )
        self._rect_factor = None
        self._rowsums: np.ndarray | None = None
        self._diag: np.ndarray | None = None
        self._m: np.ndarray | None = None
        self._c_sum = None
        self._indptr = None
        # memory-headroom visibility (what the layouts are about): the
        # resident factor bytes, labeled by format
        from ..obs.metrics import get_registry

        get_registry().gauge(
            "dpathsim_factor_bytes",
            "resident half-chain factor bytes by layout format",
        ).labels(format=self._factor_format).set(
            float(pkd.factor_bytes(factor)))

    def _apply_delta_impl(self, plan) -> None:
        """Rebind to the patched factor (ΔC came from the product rule —
        the chain is never refolded) and rebuild the tiling. A COO factor
        takes the plan's patched COO (one O(nnz) re-sort); a packed one
        is patched chunk by chunk (``packed.patch_factor``, O(Δ +
        touched chunks), the same content). The patch is done twice for
        a packed factor: ``data.delta.plan_delta`` always builds the
        patched COO too (the affected-row set is computed from the old
        and new COO, as in the JAX package) and seeds it into
        ``hin_new``'s factor cache, so after any delta ``self.hin`` keeps
        the 24-byte/nnz COO resident beside the packed factor. Device
        tiles re-densify lazily at unchanged shapes (tile_rows and V are
        fixed by the capacity invariant), and K3's kernel-ready copy, its
        u8 limbs included, is rebuilt on the next sweep."""
        self.hin = plan.hin_new  # logical n may have grown (appends)
        if self._c is None and plan.delta_c is not None:
            self._bind_factor(pkd.patch_factor(self._factor, plan.delta_c))
        else:
            self._bind_factor(plan.half_new)

    def factor_info(self) -> dict:
        nnz = pkd.factor_nnz(self._factor)
        return {
            "format": self._factor_format,
            "bytes": pkd.factor_bytes(self._factor),
            "nnz": nnz,
            "coo_bytes": 24 * nnz,  # int64 rows + int64 cols + f64 w
        }

    @property
    def _n_live_tiles(self) -> int:
        return -(-self.n // self.tiled.tile_rows)

    def _use_rect_kernel(self, k: int) -> bool:
        """K3 serves the f32 streaming regime (k < 16) within its
        candidate budget (shrink ``tile_rows`` to stay inside it at
        larger N); on the CPU only when ``rect_kernel=True`` (its plain
        version — the tests)."""
        t = self.tiled
        fits = (
            chain._is_float32(t.dtype)
            and ck.rect_supported(t.v, k)
            # the columns K3 is launched with: C's rows padded to whole
            # tiles (_topk_row_tile)
            and ck.rect_fits(t.n_tiles * t.tile_rows, t.tile_rows, k,
                             self.device, t.v)
        )
        if self._rect_kernel is not None:
            return self._rect_kernel and fits
        return fits and self.device.type == "cuda"

    # -- primitives ------------------------------------------------------

    def global_walks(self) -> np.ndarray:
        if self._rowsums is None and self._exact_rescore:
            # rescore mode: the device f32 GEMV rounds past 2^24; the
            # host f64 accumulation (integers < 2^53) is exact and was
            # already computed by the overflow detector.
            self._rowsums = self._host_rowsums
        elif self._rowsums is None:
            t = self.tiled
            with get_tracer().span("backend.factor",
                                   device=self.device) as span:
                held = t.device_bytes() if span is not None else 0
                self._rowsums = t.rowsums()[: self.n]
                if span is not None:  # the COO's upload, the cached tiles
                    span.args["bytes"] = t.device_bytes() - held
        return self._rowsums

    def commuting_matrix(self) -> np.ndarray:
        if self._m is None:
            if self.n * self.n > _DENSE_M_MAX_ENTRIES:
                raise MemoryError(
                    f"dense M would be {self.n}x{self.n}; use topk_scores()"
                )
            if self._exact_rescore:
                c = self._densify_rows_f64(np.arange(self.n))
                self._m = c @ c.T
                return self._m
            t = self.tiled
            tr = t.tile_rows
            m = np.zeros((t.n_tiles * tr, t.n_tiles * tr))
            for i in range(self._n_live_tiles):
                for j in range(i, self._n_live_tiles):
                    tile = t.m_tile(i, j).cpu().double().numpy()
                    m[i * tr:(i + 1) * tr, j * tr:(j + 1) * tr] = tile
                    if j != i:
                        m[j * tr:(j + 1) * tr, i * tr:(i + 1) * tr] = tile.T
            self._m = m[: self.n, : self.n]
        return self._m

    def pairwise_row(self, source_index: int) -> np.ndarray:
        if self._exact_rescore:
            return self.pairwise_row_exact(source_index)
        t = self.tiled
        ti, off = divmod(source_index, t.tile_rows)
        src_tile = t.tile(ti)
        out = np.zeros(t.n_tiles * t.tile_rows, dtype=np.float64)
        for j in range(self._n_live_tiles):
            tile = sp.tile_outer(src_tile[off:off + 1], t.tile(j))
            out[j * t.tile_rows:(j + 1) * t.tile_rows] = (
                tile[0].cpu().double().numpy()
            )
        return out[: self.n]

    def pairwise_rows(self, rows) -> np.ndarray:
        """Batched M[rows, :]: the source factor rows gathered into one
        dense [B, V] device block and swept across the column tiles.
        Under the exact-count guard every f32 tile product is an exact
        integer, so this agrees bit for bit with the per-row sweep; in
        exact-rescore mode each row takes the exact f64 host path."""
        rows = np.asarray(rows, dtype=np.int64)
        if self._exact_rescore:
            return np.stack([self.pairwise_row_exact(int(r)) for r in rows])
        t = self.tiled
        src = torch.as_tensor(self._densify_rows_f64(rows),
                              device=self.device).to(t.dtype)
        out = np.zeros((rows.shape[0], t.n_tiles * t.tile_rows))
        for j in range(self._n_live_tiles):
            tile = sp.tile_outer(src, t.tile(j))
            out[:, j * t.tile_rows:(j + 1) * t.tile_rows] = (
                tile.cpu().double().numpy()
            )
        return out[:, : self.n]

    def diag_walks(self) -> np.ndarray:
        """diag(M)[i] = Σ_v C[i,v]² — the textbook-PathSim denominator,
        straight from the factor in either layout (O(nnz), no dense C,
        no M)."""
        if self._diag is None:
            self._diag = pkd.factor_diag(self._factor)[: self.n]
        return self._diag

    # -- streaming rank-all ------------------------------------------------

    def _compute_path(self, k: int) -> str:
        scanned = self.tiled.dense_bytes() <= self._dense_c_budget
        if scanned and self._use_rect_kernel(k):
            return "rect"
        return "scan-fold" if scanned else "tile-fold"

    def _run_config(self, k: int, variant: str = "rowsum",
                    symmetric: bool = False) -> dict:
        """Checkpoint identity: graph fingerprint + tiling + k + score
        variant + compute path + sweep protocol. A reused directory from
        a different run must fail, not resume."""
        c = self._c
        if c is not None:
            # the raw arrays' digest (pre-canonicalization order), as the
            # JAX package keeps it for COO directories
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(c.rows, dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(c.cols, dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(c.weights,
                                          dtype=np.float64).tobytes())
            digest = h.hexdigest()[:16]
        else:
            digest = pkd.content_digest(self._factor)
        return {
            "n": int(self.n),
            "v": int(self._factor.shape[1]),
            "nnz": pkd.factor_nnz(self._factor),
            "factor_format": self._factor_format,
            "digest": digest,
            "tile_rows": int(self.tiled.tile_rows),
            "k": int(k),
            "metapath": self.metapath.name,
            "dtype": _dtype_name(self.tiled.dtype),
            "exact_counts": bool(self.exact_counts),
            "variant": variant,
            # The active arm is identity too: K3's f32 sums and the
            # folds' may round differently past 2^24, so a run started
            # on one arm must not resume on another and mix numerics
            # across row tiles.
            "compute_path": "sym" if symmetric else self._compute_path(k),
            # Bump whenever the numeric regime or the resume protocol of
            # the saved units changes: v2 = the full sweep, per-row-tile
            # units resumed independently; v3-sym = the symmetric
            # half-sweep, resumed from its rolling sym_partials unit.
            "format": "stream-topk-v3-sym" if symmetric else "stream-topk-v2",
        }

    def topk_scores(self, k: int = 10, variant: str = "rowsum",
                    checkpoint_dir: str | None = None,
                    symmetric: bool = False):
        """Streaming per-source top-k: (values f64 [N, k], indices int64
        [N, k]), self pairs excluded. In exact-rescore mode (counts past
        2^24, ``exact_counts=True``) the f32 pass runs widened to k_cand
        candidates per row and the exact host phase reduces them to the
        true top-k — bit-exact vs f64 arithmetic, certified per row.
        ``symmetric=True``: the symmetric half-sweep (see
        :meth:`_topk_scores_symmetric`) instead of the full sweep."""
        if not self._exact_rescore:
            return self._topk_scores_f32(k, variant, checkpoint_dir,
                                         symmetric)
        # k+5 keeps k=10 inside K3's k < 16 gate (the candidate set is
        # certified per row afterwards, so the margin affects fallback
        # cost, never correctness)
        k_cand = min(max(k + 5, (3 * k) // 2), max(self.n - 1, 1))
        cv, ci = self._topk_scores_f32(k_cand, variant, checkpoint_dir,
                                       symmetric)
        return self._exact_topk_rescore(k, cv, ci, variant)

    def _topk_scores_f32(self, k: int = 10, variant: str = "rowsum",
                         checkpoint_dir: str | None = None,
                         symmetric: bool = False):
        """The full sweep over row tiles: each tile's [tile, k] winners
        come back to the host, nothing larger. ``checkpoint_dir``:
        persist each completed row tile and resume on restart (tiles are
        independent units; the symmetric pass also rolls a
        ``sym_partials`` unit)."""
        ckpt = None
        if checkpoint_dir is not None:
            from ..utils.checkpoint import CheckpointManager

            ckpt = CheckpointManager(
                checkpoint_dir,
                config=self._run_config(k, variant, symmetric),
                config_defaults={"dtype": "float32", "exact_counts": True,
                                 "variant": "rowsum",
                                 "factor_format": "coo"},
            )
        if symmetric:
            return self._topk_scores_symmetric(k, ckpt, variant)
        t = self.tiled
        denoms = self._denoms_device_padded(variant)
        vals, idxs = self._empty_result(k)
        scanned = t.dense_bytes() <= self._dense_c_budget
        tracer = get_tracer()
        arm = self._compute_path(k) if tracer.enabled else None

        # Software pipeline over row tiles: the device runs tile i+1
        # while the host waits for tile i's copy into pinned memory, and
        # results still land (and checkpoint) in tile order. A tile joins
        # ``pending`` only once its launch succeeded, with its own fresh
        # output and pinned buffers, so a retried tile never sees a stale
        # in-flight buffer.
        pending: list[tuple] = []

        def drain_one():
            i_, i0_, rows_, hv, hi, done = pending.pop(0)
            with tracer.span("backend.drain", device=self.device,
                             tile=i_) as span:
                if done is not None:
                    done.synchronize()
                hv64, hi64 = hv[:rows_].double(), hi[:rows_].long()
                vals[i0_:i0_ + rows_] = hv64.numpy()
                idxs[i0_:i0_ + rows_] = hi64.numpy()
                if span is not None:  # the f64 / int64 copies made
                    span.args["bytes"] = sum(
                        new.nbytes for new, old in ((hv64, hv), (hi64, hi))
                        if new.data_ptr() != old.data_ptr())
            if ckpt is not None:
                ckpt.save_unit(
                    f"topk{k}_rowtile_{i_}",
                    vals=vals[i0_:i0_ + rows_],
                    idxs=idxs[i0_:i0_ + rows_],
                )

        for i in range(self._n_live_tiles):
            i0 = i * t.tile_rows
            rows_here = min(t.tile_rows, self.n - i0)
            key = f"topk{k}_rowtile_{i}"
            if ckpt is not None and ckpt.is_done(key):
                unit = ckpt.load_unit(key)
                vals[i0:i0 + rows_here] = unit["vals"]
                idxs[i0:i0 + rows_here] = unit["idxs"]
                continue
            # Preemption point: everything in `pending` is flushed (and
            # checkpointed) first, so the manifest covers every tile the
            # device finished — the restart redoes only tile i onward.
            if _preemption.requested():
                while pending:
                    drain_one()
                _preemption.check(
                    checkpoint_dir=str(ckpt.dir) if ckpt is not None else None
                )
            try:
                with tracer.span("backend.tile", device=self.device, tile=i,
                                 rows=rows_here, arm=arm):
                    best_v, best_i = resilience.resilient_call(
                        "tile_execute",
                        lambda i=i, i0=i0: self._topk_row_tile(
                            i, i0, k, variant, denoms, scanned
                        ),
                    )
            except BaseException:
                # The tiles in `pending` finished on the device before
                # this one failed — flush them to the checkpoint (best
                # effort: the device may be wedged) so the failure costs
                # one tile of progress, not the pipeline depth.
                if ckpt is not None:
                    try:
                        while pending:
                            drain_one()
                    except Exception:
                        pass
                raise
            pending.append((i, i0, rows_here, *_fetch_async(best_v, best_i)))
            while len(pending) >= self._PIPELINE_DEPTH:
                drain_one()
        while pending:
            drain_one()
        return vals, idxs

    def _topk_row_tile(self, i: int, i0: int, k: int, variant: str,
                       denoms, scanned: bool):
        """One row tile's top-k on the device, by the arm
        :meth:`_compute_path` names. Stateless with respect to the sweep
        (the K3 factor cache is rebuilt idempotently)."""
        t = self.tiled
        d_all = denoms()
        if scanned and self._use_rect_kernel(k):
            # K3 + pass 2 against the whole column range. The factor is
            # made kernel-ready (f32, and its u8 limbs on the card) once
            # and cached per variant: its denominators are the variant's.
            if self._rect_factor is None or self._rect_factor[0] != variant:
                self._rect_factor = (
                    variant, *ck.rect_pad_factor(t.dense_device(), d_all)
                )
                # K3 only reads the kernel-ready copy: holding the dense
                # C too would double the factor's device residency
                t.drop_dense()
            _, cc, dc, limbs = self._rect_factor
            tr = t.tile_rows
            row_ids = torch.arange(i0, i0 + tr, dtype=torch.int32,
                                   device=cc.device)
            return ck.fused_topk_twopass_rect(
                cc[i0:i0 + tr], cc, dc[i0:i0 + tr], dc, row_ids,
                k=k, n_true_cols=self.n,
                limbs=None if limbs is None else (
                    limbs.rows(i0, i0 + tr), limbs),
            )
        if scanned:
            return sp.stream_row_tile_topk(
                t.dense_device(), d_all, i0, k=k, n_true=self.n,
                tile_rows=t.tile_rows,
            )
        ci = t.tile(i)
        di = d_all[i0:i0 + t.tile_rows]
        best_v = torch.full((t.tile_rows, k), float("-inf"), dtype=t.dtype,
                            device=self.device)
        best_i = torch.zeros((t.tile_rows, k), dtype=torch.int32,
                             device=self.device)
        for j in range(self._n_live_tiles):
            j0 = j * t.tile_rows
            best_v, best_i = sp.stream_merge_topk(
                ci, t.tile(j), di, d_all[j0:j0 + t.tile_rows],
                best_v, best_i, i0, j0, k=k, n_true=self.n,
            )
        return best_v, best_i

    def _denoms_device_padded(self, variant: str = "rowsum"):
        """Lazy padded denominator vector on the device: a run resuming
        entirely from checkpoint never touches the graph."""
        if variant not in ("rowsum", "diagonal"):
            raise ValueError(f"unknown PathSim variant {variant!r}")
        t = self.tiled
        d_dev = None

        def denoms_device():
            nonlocal d_dev
            if d_dev is None:
                d_pad = np.zeros(t.n_tiles * t.tile_rows)
                d_pad[: self.n] = (
                    self.global_walks() if variant == "rowsum"
                    else self.diag_walks()
                )
                d_dev = torch.as_tensor(d_pad, device=self.device).to(t.dtype)
            return d_dev

        return denoms_device

    def _empty_result(self, k: int):
        with get_tracer().span("backend.result_alloc",
                               device=self.device) as span:
            out = (
                np.full((self.n, k), -np.inf),
                np.zeros((self.n, k), dtype=np.int64),
            )
            if span is not None:
                span.args["bytes"] = out[0].nbytes + out[1].nbytes
        return out

    # -- symmetric half-sweep ------------------------------------------------

    _PARTIALS_PREFIX = "sym_partials_after_"
    # Partials snapshot cadence: a resume redoes at most this many outer
    # tiles; a snapshot every tile would cost O(n_tiles²·tile_rows·k) I/O.
    _PARTIALS_EVERY = 8

    def _topk_scores_symmetric(self, k: int, ckpt, variant: str = "rowsum"):
        """Symmetric half-sweep: outer tile i, inner j ∈ [i, n_tiles);
        each off-diagonal tile folds into row blocks i AND j
        (sp.stream_merge_topk_pair). Row block r is complete when outer
        iteration r finishes — contributions (i < r, j = r) arrived
        during earlier outer iterations, (r, j ≥ r) during its own. Tie
        order (ascending global column per row) is the full sweep's,
        because every row block's folds arrive in ascending column
        order. It runs the torch ops of the JAX package's XLA fold (not
        K3): the same algorithm and tie order.

        Resume protocol: every _PARTIALS_EVERY outer tiles (and at a
        preemption) a snapshot of the not-yet-finished row blocks lands
        under its own unit key (``sym_partials_after_{i}``); the previous
        snapshot is dropped only after the new one is durable, and a
        resume keeps only the newest (a crash between the two leaves an
        older one behind). A restart redoes at most _PARTIALS_EVERY
        outer tiles; their row units are overwritten with identical
        results."""
        t = self.tiled
        dev = self.device
        denoms = self._denoms_device_padded(variant)
        vals, idxs = self._empty_result(k)
        empty_v = torch.full((t.tile_rows, k), float("-inf"), dtype=t.dtype,
                             device=dev)
        empty_i = torch.zeros((t.tile_rows, k), dtype=torch.int32,
                              device=dev)
        n_live = self._n_live_tiles
        best = {j: (empty_v, empty_i) for j in range(n_live)}

        start = 0
        prev_key = None
        if ckpt is not None:
            snaps = [key for key in ckpt.done_keys()
                     if key.startswith(self._PARTIALS_PREFIX)]
            if snaps:
                prev_key = max(
                    snaps, key=lambda s: int(s[len(self._PARTIALS_PREFIX):]))
                for stale in snaps:
                    if stale != prev_key:
                        ckpt.drop_unit(stale)
                after = int(prev_key[len(self._PARTIALS_PREFIX):])
                part = ckpt.load_unit(prev_key)
                # rows <= after were saved before the snapshot (the save
                # order below); reload them
                for i in range(after + 1):
                    unit = ckpt.load_unit(f"topk{k}_rowtile_{i}")
                    i0 = i * t.tile_rows
                    rows_here = min(t.tile_rows, self.n - i0)
                    vals[i0:i0 + rows_here] = unit["vals"]
                    idxs[i0:i0 + rows_here] = unit["idxs"]
                for pos, j in enumerate(range(after + 1, n_live)):
                    best[j] = (
                        torch.as_tensor(part["vals"][pos], device=dev).to(
                            t.dtype),
                        torch.as_tensor(part["idxs"][pos], device=dev).to(
                            torch.int32),
                    )
                start = after + 1

        for i in range(start, n_live):
            # Preemption point (outer-tile boundary): every finished row
            # unit is already durable; a fresh partials snapshot makes the
            # restart resume exactly here.
            if _preemption.requested():
                if ckpt is not None and i > start:
                    prev_key = self._save_sym_partials(
                        ckpt, best, after=i - 1, prev_key=prev_key, k=k)
                _preemption.check(
                    checkpoint_dir=str(ckpt.dir) if ckpt is not None else None
                )
            i0 = i * t.tile_rows
            rows_here = min(t.tile_rows, self.n - i0)
            ci = t.tile(i)
            d_all = denoms()
            di = d_all[i0:i0 + t.tile_rows]
            bv, bi = best[i]
            # Each merge is one tile_execute attempt, its result assigned
            # only on success: the merge is not idempotent (a duplicate
            # fold would duplicate candidate indices in the top-k list).
            bv, bi = resilience.resilient_call(
                "tile_execute",
                lambda: sp.stream_merge_topk(
                    ci, ci, di, di, bv, bi, i0, i0, k=k, n_true=self.n),
            )
            for j in range(i + 1, n_live):
                j0 = j * t.tile_rows
                cj = t.tile(j)
                dj = d_all[j0:j0 + t.tile_rows]
                bjv, bji = best[j]
                bv, bi, bjv, bji = resilience.resilient_call(
                    "tile_execute",
                    lambda cj=cj, dj=dj, j0=j0, bv=bv, bi=bi, bjv=bjv,
                    bji=bji: sp.stream_merge_topk_pair(
                        ci, cj, di, dj, bv, bi, bjv, bji, i0, j0,
                        k=k, n_true=self.n),
                )
                best[j] = (bjv, bji)
            vals[i0:i0 + rows_here] = bv[:rows_here].cpu().double().numpy()
            idxs[i0:i0 + rows_here] = bi[:rows_here].cpu().long().numpy()
            del best[i]  # complete; its state is in vals/idxs now
            if ckpt is not None:
                ckpt.save_unit(
                    f"topk{k}_rowtile_{i}",
                    vals=vals[i0:i0 + rows_here],
                    idxs=idxs[i0:i0 + rows_here],
                )
                last = i == n_live - 1
                if (i % self._PARTIALS_EVERY == self._PARTIALS_EVERY - 1
                        or last):
                    prev_key = self._save_sym_partials(
                        ckpt, best, after=i, prev_key=prev_key, k=k)
        return vals, idxs

    def _save_sym_partials(self, ckpt, best: dict, after: int,
                           prev_key: str | None, k: int) -> str:
        """Snapshot the running bests of row tiles > ``after`` under
        ``sym_partials_after_{after}`` and drop the superseded snapshot
        only once the new one is durable (save_unit writes all arrays
        before the manifest references them). Re-saving the same key
        overwrites identical contents."""
        t = self.tiled
        rest = range(after + 1, self._n_live_tiles)
        new_key = f"{self._PARTIALS_PREFIX}{after}"
        if len(rest):
            sv = np.stack([best[j][0].cpu().numpy() for j in rest])
            si = np.stack([best[j][1].cpu().numpy() for j in rest])
        else:
            sv = np.zeros((0, t.tile_rows, k),
                          dtype=np.float32)
            si = np.zeros((0, t.tile_rows, k), dtype=np.int32)
        ckpt.save_unit(new_key, vals=sv, idxs=si)
        if prev_key is not None and prev_key != new_key:
            ckpt.drop_unit(prev_key)  # only after the new one is durable
        return new_key

    # ------------------------------------------------------------------
    # Exact-counts phase (counts past 2^24): f64 host rescoring of the
    # f32 pass's candidates. Selection stays on the device in f32;
    # exactness costs one O(N·k_cand·V) host einsum over integers < 2^53
    # (exact in f64), not f64 in the hot loop.
    # ------------------------------------------------------------------

    def _csr_factor(self):
        """(coalesced row-major COO, indptr) for the rescore helpers.
        The factor is not assumed sorted or duplicate-free: a single-step
        half chain (APA) is the raw adjacency block."""
        if self._c_sum is None:
            self._c_sum = self._c.summed()  # COO factors only
            self._indptr = np.searchsorted(
                self._c_sum.rows, np.arange(self.n + 1)
            )
        return self._c_sum, self._indptr

    def _densify_rows_f64(self, rows: np.ndarray) -> np.ndarray:
        """Dense f64 [len(rows), V] gather of arbitrary factor rows. A
        packed factor gathers through the sanctioned accessor: the same
        exact integers, a chunk-transient decode instead of a resident
        CSR copy."""
        if self._c is None:
            return pkd.gather_rows_dense(self._factor,
                                         np.asarray(rows, dtype=np.int64))
        s, indptr = self._csr_factor()
        rows = np.asarray(rows, dtype=np.int64)
        starts = indptr[rows]
        counts = indptr[rows + 1] - starts
        total = int(counts.sum())
        out = np.zeros((rows.shape[0], self.tiled.v), dtype=np.float64)
        if total:
            ridx = np.repeat(np.arange(rows.shape[0]), counts)
            cum = np.concatenate([[0], np.cumsum(counts)])
            flat = np.repeat(starts, counts) + (
                np.arange(total) - np.repeat(cum[:-1], counts)
            )
            out[ridx, s.cols[flat]] = s.weights[flat]
        return out

    def _f32_score_relerr_bound(self) -> float:
        """Rigorous relative-error bound on a score from the f32 pass:
        the GEMM's error ≤ (V+2)u·m for non-negative data, plus input
        casts, the denominator GEMV and the final divide — (2V+16)u
        covers every path, doubled for defense. u = 2^-24."""
        return (2.0 * self.tiled.v + 16.0) * 2.0**-24 * 2.0

    def _exact_topk_rescore(self, k: int, cand_vals: np.ndarray,
                            cand_idxs: np.ndarray, variant: str):
        """Reduce the f32 pass's [N, k_cand] candidates to the exact
        top-k: gather candidate factor rows dense (f64), one einsum for
        the pairwise walks, exact normalize, (−score, column) selection —
        the oracle's tie-break. Soundness certificate per row: any
        non-candidate j has f32 score ≤ the last kept candidate's, so
        its true score is ≤ that·(1+ε); if the exact k-th candidate
        beats that bound (or every non-self column is a candidate, or
        the last f32 score is exactly 0 — zero scores are error-free for
        integer data), the candidate set provably holds the true top-k.
        Rows that fail the certificate get a full exact row sweep."""
        d = np.asarray(
            self.global_walks() if variant == "rowsum" else self.diag_walks(),
            dtype=np.float64,
        )
        n, v = self.n, self.tiled.v
        k_cand = cand_idxs.shape[1]
        kk = min(k, k_cand)
        eps = self._f32_score_relerr_bound()
        out_v = np.full((n, k), -np.inf)
        out_i = np.zeros((n, k), dtype=np.int64)
        chunk = max(64, int((256 << 20) // max(k_cand * v * 8, 1)))
        flagged: list[np.ndarray] = []
        all_cands = n - 1 <= k_cand
        for i0 in range(0, n, chunk):
            i1 = min(i0 + chunk, n)
            rows = np.arange(i0, i1)
            ci = self._densify_rows_f64(rows)
            cid = np.asarray(cand_idxs[i0:i1], dtype=np.int64)
            valid = np.isfinite(cand_vals[i0:i1])
            safe_id = np.where(valid, cid, 0)
            cj = self._densify_rows_f64(safe_id.ravel()).reshape(
                i1 - i0, k_cand, v
            )
            m = np.einsum("tv,tcv->tc", ci, cj)
            den = d[rows][:, None] + d[safe_id]
            sc = np.where(den > 0, 2.0 * m / np.where(den > 0, den, 1.0), 0.0)
            sc = np.where(valid, sc, -np.inf)
            order = np.lexsort((safe_id, -sc), axis=-1)[:, :kk]
            out_v[i0:i1, :kk] = np.take_along_axis(sc, order, axis=1)
            out_i[i0:i1, :kk] = np.take_along_axis(safe_id, order, axis=1)
            if not all_cands:
                last_f32 = np.asarray(cand_vals[i0:i1, -1], dtype=np.float64)
                kth = out_v[i0:i1, kk - 1]
                sound = (last_f32 == 0.0) | (kth > last_f32 * (1.0 + eps))
                if not sound.all():
                    flagged.append(rows[~sound])
        # how often the certificate failed (scale runs report it)
        self._last_fallback_rows = int(sum(f.shape[0] for f in flagged))
        if flagged:
            self._exact_full_rows(np.concatenate(flagged), d, k, out_v, out_i)
        return out_v, out_i

    def _exact_full_rows(self, rows: np.ndarray, d: np.ndarray, k: int,
                         out_v: np.ndarray, out_i: np.ndarray) -> None:
        """Exact f64 scores of ``rows`` against every column, top-k with
        the (−score, ascending column) tie-break — the uncertifiable-row
        fallback, needed exactly when score ties span the candidate
        boundary. Both axes are chunked: the score block never exceeds
        ~256 MB however many rows were flagged."""
        n = self.n
        col_chunk = max(256, int((64 << 20) // max(self.tiled.v * 8, 1)))
        row_chunk = max(64, int((256 << 20) // max(col_chunk * 8, 1)))
        for r0 in range(0, rows.shape[0], row_chunk):
            rblk = rows[r0:r0 + row_chunk]
            ci = self._densify_rows_f64(rblk)
            di = d[rblk]
            best_v = np.full((rblk.shape[0], 0), -np.inf)
            best_c = np.zeros((rblk.shape[0], 0), dtype=np.int64)
            for j0 in range(0, n, col_chunk):
                j1 = min(j0 + col_chunk, n)
                cj = self._densify_rows_f64(np.arange(j0, j1))
                m = ci @ cj.T
                den = di[:, None] + d[j0:j1][None, :]
                sc = np.where(den > 0, 2.0 * m / np.where(den > 0, den, 1.0),
                              0.0)
                cols = np.broadcast_to(np.arange(j0, j1), sc.shape).copy()
                sc = np.where(cols == rblk[:, None], -np.inf, sc)  # self
                kk = min(k, sc.shape[1])
                o = np.lexsort((cols, -sc), axis=-1)[:, :kk]
                merged_v = np.concatenate(
                    [best_v, np.take_along_axis(sc, o, axis=1)], axis=1
                )
                merged_c = np.concatenate(
                    [best_c, np.take_along_axis(cols, o, axis=1)], axis=1
                )
                o = np.lexsort((merged_c, -merged_v), axis=-1)[:, :k]
                best_v = np.take_along_axis(merged_v, o, axis=1)
                best_c = np.take_along_axis(merged_c, o, axis=1)
            kk = best_v.shape[1]
            out_v[rblk, :kk] = best_v
            out_i[rblk, :kk] = best_c

    def pairwise_row_exact(self, source_index: int) -> np.ndarray:
        """M[source, :] with exact f64 host arithmetic — the rescore-mode
        counterpart of :meth:`pairwise_row`."""
        ci = self._densify_rows_f64(np.array([source_index]))[0]
        out = np.zeros(self.n, dtype=np.float64)
        chunk = max(256, int((128 << 20) // max(self.tiled.v * 8, 1)))
        for j0 in range(0, self.n, chunk):
            j1 = min(j0 + chunk, self.n)
            out[j0:j1] = self._densify_rows_f64(np.arange(j0, j1)) @ ci
        return out


def _fetch_async(vals: torch.Tensor, idxs: torch.Tensor):
    """Start the host copy of a row tile's result: on the card into
    pinned buffers without blocking the host, with an event to wait on;
    on the CPU the tensors already are host tensors. Returns (host
    values, host indices, event or None)."""
    if vals.device.type != "cuda":
        return vals, idxs, None
    with get_tracer().span("backend.fetch", device=vals.device,
                           pinned=True) as span:
        hv = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        hi = torch.empty(idxs.shape, dtype=idxs.dtype, pin_memory=True)
        with torch.cuda.device(vals.device):
            hv.copy_(vals, non_blocking=True)
            hi.copy_(idxs, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        if span is not None:
            span.args["bytes"] = hv.nbytes + hi.nbytes
    return hv, hi, done
