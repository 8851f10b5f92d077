"""Sparse half-chain machinery: host COO folding, the two-pass top-k's
second pass, and the device half of the streaming sparse tier.

The *structure* of the half-chain product — which (source, venue)-style
pairs exist — is a sort/searchsorted join on the host (O(nnz log nnz),
numpy); the *numbers* — duplicate accumulation, row sums, score tiles —
run on the device. This replaces the reference's per-query 4-way
distributed hash join with one precomputed join reused by every query,
and it never builds a P×V or N×N dense intermediate.

The delta algebra (``coo_nonzero`` to ``affected_source_rows``) patches
the COO factor for a graph delta by the product rule, O(Δ·deg), and
bounds the score rows the delta can change — the serving layer's
``update`` op rests on it.

:func:`chunked_row_topk` is the exact hierarchical top-k that reduces
the CUDA candidate kernels' winners to each row's final top-k.

The device half (``densify_tile`` down to :class:`TiledHalfChain`) is the
torch counterpart of the JAX package's static-shaped scatter + tile
GEMMs: row tiles of C densified on demand from the host COO, tile
products in true f32, and the fold of score tiles into running per-row
top-k lists (a Python loop over column tiles stands in for
``lax.scan``); :func:`stream_merge_topk_pair` folds one tile into two
row blocks' lists at once (the symmetric half-sweep). The tiled view
reads a COO factor or a packed one (ops/packed.py) alike."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs.trace import get_tracer


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Weighted COO with possibly-duplicate coordinates ("unsummed")."""

    rows: np.ndarray  # int [nnz]
    cols: np.ndarray  # int [nnz]
    weights: np.ndarray  # float64 [nnz]
    shape: tuple[int, int]

    def summed(self) -> "COOMatrix":
        """Coalesce duplicates (host)."""
        key = self.rows.astype(np.int64) * self.shape[1] + self.cols
        uniq, inv = np.unique(key, return_inverse=True)
        w = np.zeros(uniq.shape[0], dtype=np.float64)
        np.add.at(w, inv, self.weights)
        return COOMatrix(
            rows=(uniq // self.shape[1]).astype(np.int64),
            cols=(uniq % self.shape[1]).astype(np.int64),
            weights=w,
            shape=self.shape,
        )


def coo_from_block(block) -> COOMatrix:
    return COOMatrix(
        rows=block.rows.astype(np.int64),
        cols=block.cols.astype(np.int64),
        weights=np.ones(block.rows.shape[0], dtype=np.float64),
        shape=block.shape,
    )


def coo_matmul(a: COOMatrix, b: COOMatrix) -> COOMatrix:
    """Host COO·COO join on the shared middle index.

    Sort b by row, locate each a-edge's matching slice via searchsorted,
    expand pairs, multiply weights. Output is unsummed (duplicates carry
    partial products) — coalesce with .summed() when needed.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    order = np.argsort(b.rows, kind="stable")
    b_rows = b.rows[order]
    b_cols = b.cols[order]
    b_w = b.weights[order]

    start = np.searchsorted(b_rows, a.cols, side="left")
    stop = np.searchsorted(b_rows, a.cols, side="right")
    counts = stop - start
    total = int(counts.sum())

    # For each a-edge i, take b entries [start[i], stop[i]).
    a_idx = np.repeat(np.arange(a.rows.shape[0]), counts)
    # offsets within each slice: ramp resetting at slice boundaries
    cum = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(total) - np.repeat(cum[:-1], counts)
    b_idx = np.repeat(start, counts) + within

    return COOMatrix(
        rows=a.rows[a_idx],
        cols=b_cols[b_idx],
        weights=a.weights[a_idx] * b_w[b_idx],
        shape=(a.shape[0], b.shape[1]),
    )


def matmul_summed(a: COOMatrix, b: COOMatrix) -> COOMatrix:
    """One coalesced COO product: the native C++ SpGEMM when it is built
    (native/coo_fast.cpp; identical output: row-major sorted, exact
    integer accumulation in f64), else the numpy join."""
    from ..native import coo_native

    if coo_native.available():
        return coo_native.coo_matmul_summed(a, b)
    return coo_matmul(a, b).summed()


# ---------------------------------------------------------------------------
# Delta algebra: O(Δ·deg) updates to the half-chain factor
# ---------------------------------------------------------------------------
#
# The half-chain factor C is the one precomputed join every backend
# shares; a graph delta must patch it without refolding the chain. For a
# 2-block half C = A·B the product rule gives an exact COO identity:
#
#     ΔC = ΔA·B_new + A_old·ΔB
#
# where ΔA/ΔB carry SIGNED weights (+1 per added edge, −1 per removed
# edge). Each term is a coo_matmul over only the delta's nnz — O(Δ·deg),
# never O(nnz). For a 1-block half, ΔC = ΔA directly. Longer halves
# (none exist in the DBLP schema family) would need the intermediate
# partial products the backends don't keep, so they diff the refolded
# factor instead — still recompile-free, just not O(Δ).


def coo_nonzero(c: COOMatrix) -> COOMatrix:
    """Drop explicit zeros (a removed-then-unchanged coordinate after
    coalescing) so downstream support-based reasoning sees true nnz."""
    keep = c.weights != 0.0
    if keep.all():
        return c
    return COOMatrix(
        rows=c.rows[keep], cols=c.cols[keep], weights=c.weights[keep],
        shape=c.shape,
    )


def coo_delta_fold(
    old_blocks: list[COOMatrix], delta_blocks: list[COOMatrix]
) -> COOMatrix:
    """ΔC for a half chain, by the product rule (coalesced, zero-free,
    signed). ``old_blocks`` are the PRE-delta oriented blocks,
    ``delta_blocks`` the signed edge deltas in the same orientation
    (empty deltas allowed — nnz 0)."""
    if len(old_blocks) == 1:
        return coo_nonzero(delta_blocks[0].summed())
    if len(old_blocks) == 2:
        a_old, b_old = old_blocks
        da, db = delta_blocks
        b_new = COOMatrix(
            rows=np.concatenate([b_old.rows, db.rows]),
            cols=np.concatenate([b_old.cols, db.cols]),
            weights=np.concatenate([b_old.weights, db.weights]),
            shape=b_old.shape,
        )
        term1 = coo_matmul(da, b_new)
        term2 = coo_matmul(a_old, db)
        merged = COOMatrix(
            rows=np.concatenate([term1.rows, term2.rows]),
            cols=np.concatenate([term1.cols, term2.cols]),
            weights=np.concatenate([term1.weights, term2.weights]),
            shape=term1.shape,
        )
        return coo_nonzero(merged.summed())
    # General chain: diff the refolded factor (exact, not O(Δ) — the
    # backends keep no intermediate partials to apply the product rule
    # against). Callers treat a wide ΔC like any other; recompile-free
    # serving is preserved either way. The refold is plan-ordered, like
    # every other fold (planner.fold_blocks).
    from . import planner

    new_blocks = []
    for ob, db in zip(old_blocks, delta_blocks):
        new_blocks.append(
            COOMatrix(
                rows=np.concatenate([ob.rows, db.rows]),
                cols=np.concatenate([ob.cols, db.cols]),
                weights=np.concatenate([ob.weights, db.weights]),
                shape=ob.shape,
            ).summed()
        )
    c_new = planner.fold_blocks(new_blocks)
    c_old = planner.fold_blocks([b.summed() for b in old_blocks])
    merged = COOMatrix(
        rows=np.concatenate([c_new.rows, c_old.rows]),
        cols=np.concatenate([c_new.cols, c_old.cols]),
        weights=np.concatenate([c_new.weights, -c_old.weights]),
        shape=c_new.shape,
    )
    return coo_nonzero(merged.summed())


def coo_apply_delta(c: COOMatrix, delta_c: COOMatrix) -> COOMatrix:
    """Patch C row-granularly: rows untouched by ΔC are kept verbatim
    (one boolean mask + memcpy — no global re-sort, no global
    coalesce); touched rows are re-coalesced from their old entries
    plus ΔC. Exact for signed integer weights; entries cancelled to
    zero are dropped so the patched factor's support equals a rebuilt
    factor's."""
    if delta_c.rows.shape[0] == 0:
        return c
    if c.shape != delta_c.shape:
        raise ValueError(f"delta shape {delta_c.shape} != factor {c.shape}")
    touched = np.unique(delta_c.rows)
    hit = np.isin(c.rows, touched)
    patched = COOMatrix(
        rows=np.concatenate([c.rows[hit], delta_c.rows]),
        cols=np.concatenate([c.cols[hit], delta_c.cols]),
        weights=np.concatenate([c.weights[hit], delta_c.weights]),
        shape=c.shape,
    )
    patched = coo_nonzero(patched.summed())
    return COOMatrix(
        rows=np.concatenate([c.rows[~hit], patched.rows]),
        cols=np.concatenate([c.cols[~hit], patched.cols]),
        weights=np.concatenate([c.weights[~hit], patched.weights]),
        shape=c.shape,
    )


def affected_source_rows(
    c_old: COOMatrix,
    c_new: COOMatrix,
    delta_c: COOMatrix,
    n_logical: int,
) -> np.ndarray:
    """Sound superset of the source rows whose SCORE row changes under
    ΔC, for both denominator variants. Derivation (M = C·Cᵀ, d the
    rowsum or diagonal denominator):

    - R = rows of ΔC: their counts row and denominator change.
    - d may also change for rows supported on Δcolsum's columns
      (rowsum variant: d_i = Σ_v C[i,v]·colsum[v]).
    - score(i, j) = 2M[i,j]/(d_i+d_j) changes for i ∉ R∪D only through
      M[i,j] (j ∈ R, needs C[i] ∩ cols(ΔC)) or d_j (j ∈ D, needs
      M[i,j] ≠ 0, i.e. C[i] ∩ supp(C[j])).

    So with W = cols(ΔC) ∪ cols(C rows in R∪D), every changed score row
    lies in R ∪ {i : C_new[i] has support on W} — a couple of O(nnz)
    vectorized masks, no score is ever computed. (A zero M entry stays
    score 0 whatever the denominators do, which is what bounds the
    2-hop spread to supp(C[j]).)"""
    if delta_c.rows.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    r_rows = np.unique(delta_c.rows)
    dcolsum = np.zeros(c_old.shape[1], dtype=np.float64)
    np.add.at(dcolsum, delta_c.cols, delta_c.weights)
    dv_cols = np.flatnonzero(dcolsum)
    # D superset: rows of the NEW factor supported on Δcolsum columns,
    # plus R (removals can only shrink support of rows already in R).
    col_hit = np.zeros(c_old.shape[1], dtype=bool)
    col_hit[np.unique(delta_c.cols)] = True
    col_hit[dv_cols] = True
    d_sup = np.union1d(r_rows, np.unique(c_new.rows[col_hit[c_new.cols]]))
    # W: ΔC's columns plus every column supported by a row in R ∪ D
    # (old and new support both, so removed overlap still invalidates).
    row_hit = np.zeros(c_old.shape[0], dtype=bool)
    row_hit[d_sup] = True
    w_mask = col_hit.copy()
    w_mask[np.unique(c_old.cols[row_hit[c_old.rows]])] = True
    w_mask[np.unique(c_new.cols[row_hit[c_new.rows]])] = True
    affected = np.union1d(
        r_rows, np.unique(c_new.rows[w_mask[c_new.cols]])
    )
    affected = np.union1d(affected, np.unique(c_old.rows[w_mask[c_old.cols]]))
    return affected[affected < n_logical].astype(np.int64)


def _stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis in (descending value, ascending
    position) order. A stable descending sort keeps equal values in
    position order; ``torch.topk`` does not promise that on CUDA."""
    v, p = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], p[..., :k]


def chunked_row_topk(s: torch.Tensor, cols: torch.Tensor, k: int,
                     chunk: int = 512):
    """Exact per-row top-k of a wide tile, hierarchically: top-k inside
    each ``chunk``-wide column slab, then top-k over the surviving
    n_chunks·k candidates. Any global top-k element is its slab's top-k,
    so this is exact, and the sorts stay narrow. Tie-breaks match one
    flat stable sort (ascending position): slabs are laid out in
    position order and every sort is stable.

    ``cols`` carries each element's global column id. Returns
    ([T, kk] values, [T, kk] global columns) with kk = min(k, W).
    """
    t, w = s.shape
    if w <= max(chunk, k):  # narrow tile: one flat sort is already cheap
        v, p = _stable_topk(s, min(k, w))
        return v, torch.gather(cols, 1, p)
    pad = (-w) % chunk
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
        # Continue each row's column ids past the edge (not constant 0):
        # a padding slot that is ever selected must not alias column 0.
        cont = cols[:, -1:] + 1 + torch.arange(
            pad, dtype=cols.dtype, device=cols.device
        )
        cols = torch.cat([cols, cont], dim=1)
    n_chunks = s.shape[1] // chunk
    kk = min(k, chunk)
    v3, p3 = _stable_topk(s.reshape(t, n_chunks, chunk), kk)
    c3 = torch.gather(cols.reshape(t, n_chunks, chunk), 2, p3)
    cand_v = v3.reshape(t, n_chunks * kk)
    cand_c = c3.reshape(t, n_chunks * kk)
    v, p = _stable_topk(cand_v, min(k, cand_v.shape[1]))
    return v, torch.gather(cand_c, 1, p)


# ---------------------------------------------------------------------------
# Device side: scatter + tile GEMMs
# ---------------------------------------------------------------------------


def densify_tile(rows, cols, weights, n_rows: int, n_cols: int):
    """Scatter a (padded) COO slice into a dense [n_rows, n_cols] tile
    on ``weights``' device. Duplicates accumulate; padding entries must
    carry weight 0 (they scatter harmlessly)."""
    out = torch.zeros((n_rows, n_cols), dtype=weights.dtype,
                      device=weights.device)
    return out.index_put_((rows, cols), weights, accumulate=True)


def tile_outer(c_tile_i, c_tile_j):
    """One [Ti, Tj] tile of M = C Cᵀ (true f32 on the card: the entry
    points turn TF32 off)."""
    return torch.matmul(c_tile_i, c_tile_j.T)


def tile_rowsums(c_tile, colsum_total):
    return torch.matmul(c_tile, colsum_total)


def _merge_best(best_v, best_i, tile_v, tile_i, k: int):
    """Merge a tile's per-row winners into the carried [T, k] best: the
    carried entries come first, so a stable sort keeps the earlier
    (lower-column) one of equal values."""
    merged_v = torch.cat([best_v, tile_v], dim=1)
    merged_i = torch.cat([best_i, tile_i], dim=1)
    v, p = _stable_topk(merged_v, k)
    return v, torch.gather(merged_i, 1, p)


def _score_tile(ci, cj, di, dj):
    m = torch.matmul(ci, cj.T)
    denom = di[:, None] + dj[None, :]
    return torch.where(denom > 0, (2.0 * m) / denom, 0.0)


def stream_merge_topk(ci, cj, di, dj, best_v, best_i, i0: int, j0: int,
                      k: int, n_true: int):
    """Fold one [Ti, Tj] score tile into the running per-row top-k on the
    device: GEMM, normalize, mask (self pairs + padding columns >=
    n_true), hierarchical per-tile top-k, merge with the carried [Ti, k]
    best. Only the final [Ti, k] result ever reaches the host. One
    definition serves the per-tile and the scanned row-tile paths, so
    their numerics and tie-breaks agree."""
    s = _score_tile(ci, cj, di, dj)
    rows = i0 + torch.arange(s.shape[0], device=s.device)[:, None]
    cols = (j0 + torch.arange(s.shape[1], device=s.device,
                              dtype=torch.int32))[None, :]
    s = s.masked_fill((cols >= n_true) | (rows == cols), float("-inf"))
    return _merge_best(best_v, best_i,
                       *chunked_row_topk(s, cols.expand(s.shape), k), k)


def stream_merge_topk_pair(ci, cj, di, dj, bi_v, bi_i, bj_v, bj_i,
                           i0: int, j0: int, k: int, n_true: int):
    """Score ONE [Ti, Tj] tile and fold it into BOTH running top-ks:
    tile i's rows directly and tile j's rows through the transpose — the
    score matrix is symmetric (M = C·Cᵀ, denominators symmetric), so one
    GEMM serves two row blocks: the off-diagonal step of the symmetric
    half-sweep, half the GEMMs of the full sweep. The transposed fold's
    candidates are tile i's rows in ascending order, so with the folds
    of each row block arriving in ascending column order the tie order
    is the full sweep's."""
    s = _score_tile(ci, cj, di, dj)
    rows = (i0 + torch.arange(s.shape[0], device=s.device,
                              dtype=torch.int32))[:, None]
    cols = (j0 + torch.arange(s.shape[1], device=s.device,
                              dtype=torch.int32))[None, :]
    # Mask padding on BOTH axes (each is the column axis of one of the
    # two folds) and self pairs (symmetric by construction).
    s = s.masked_fill((cols >= n_true) | (rows >= n_true) | (rows == cols),
                      float("-inf"))
    bi_v, bi_i = _merge_best(bi_v, bi_i,
                             *chunked_row_topk(s, cols.expand(s.shape), k), k)
    st = s.T  # [Tj, Ti]; the transposed view's columns are tile i's rows
    bj_v, bj_i = _merge_best(
        bj_v, bj_i, *chunked_row_topk(st, rows.T.expand(st.shape), k), k)
    return bi_v, bi_i, bj_v, bj_i


def stream_row_tile_topk(c_all, d_all, i0: int, k: int, n_true: int,
                         tile_rows: int):
    """One row tile's top-k: the shared fold over every column tile of
    the device-resident dense C (rows padded to whole tiles), in column
    order. The general-dtype / over-budget arm beside K3."""
    ci = c_all[i0:i0 + tile_rows]
    di = d_all[i0:i0 + tile_rows]
    best_v = torch.full((tile_rows, k), float("-inf"), dtype=c_all.dtype,
                        device=c_all.device)
    best_i = torch.zeros((tile_rows, k), dtype=torch.int32,
                         device=c_all.device)
    for j0 in range(0, c_all.shape[0], tile_rows):
        best_v, best_i = stream_merge_topk(
            ci, c_all[j0:j0 + tile_rows], di, d_all[j0:j0 + tile_rows],
            best_v, best_i, i0, j0, k, n_true,
        )
    return best_v, best_i


class TiledHalfChain:
    """Row-tiled dense view of a sparse half-chain factor C [N, V].

    C is kept as row-sorted COO on the host (for the exact host paths)
    and, uploaded once, on the device; tiles of ``tile_rows`` rows are
    densified there on demand from slices of it and kept in a bounded
    LRU, so a sweep over the tiles moves no data from the host. Behind
    the ``factor_format`` knob the host holds a compressed
    :class:`~.packed.PackedFactor` instead, whose chunks align with the
    tile rows: each tile's COO span is decoded transiently through the
    sanctioned accessors and uploaded, and the 24-byte/nnz arrays are
    never resident (on the host or the card). The scatter, its pad
    bucket and the numerics are the same either way. V (the contracted
    width, e.g. #venues) is one dense axis: it is orders of magnitude
    smaller than N in every target configuration.
    """

    def __init__(self, c, tile_rows: int = 4096,
                 dtype=torch.float32, device="cpu",
                 exact_counts: bool = True, nnz_bucket_floor: int = 1):
        from . import chain
        from . import packed as pkd

        self.n, self.v = c.shape
        self.tile_rows = int(tile_rows)
        self.dtype = dtype
        self.device = torch.device(device)
        self.n_tiles = (self.n + self.tile_rows - 1) // self.tile_rows
        self._packed = c if pkd.is_packed(c) else None
        if self._packed is None:
            order = np.argsort(c.rows, kind="stable")
            self._rows = c.rows[order]
            self._cols = c.cols[order]
            self._weights = c.weights[order]
            bounds = np.arange(self.n_tiles + 1) * self.tile_rows
            self._tile_start = np.searchsorted(self._rows, bounds[:-1],
                                               side="left")
            self._tile_stop = np.searchsorted(self._rows, bounds[1:],
                                              side="left")
            tile_nnz = self._tile_stop - self._tile_start
            self._host_factor = COOMatrix(rows=self._rows, cols=self._cols,
                                          weights=self._weights,
                                          shape=c.shape)
        else:
            self._rows = self._cols = self._weights = None
            self._tile_start = self._tile_stop = None
            tile_nnz = np.asarray([
                pkd.row_range_nnz(c, i * self.tile_rows,
                                  (i + 1) * self.tile_rows)
                for i in range(self.n_tiles)
            ], dtype=np.int64)
            self._host_factor = c
        # Exact global column totals in f64 on the host (a packed factor
        # carries its own, kept patched by the delta path): the row sums
        # are C @ colsum_total and must stay integer-exact.
        colsum = np.asarray(pkd.factor_colsum(self._host_factor),
                            dtype=np.float64)
        self.colsum_total = colsum
        max_nnz = int(tile_nnz.max()) if self.n_tiles else 0
        # Every tile's scatter is padded to one power-of-two length, as in
        # the JAX package, where the pad is the compiled scatter's shape:
        # the scatter's shapes stay fixed for the backend's life (what a
        # CUDA graph capture needs). The bucket's floor is the tuned
        # ``sparse_nnz_floor`` (untuned: 1). Pad entries carry weight 0
        # and land on distinct cells: index_put_'s accumulate sums
        # duplicates of one index serially, and a million pad entries on
        # one cell cost tens of ms a tile.
        self._max_nnz = (
            max(max(1, int(nnz_bucket_floor)),
                1 << (max_nnz - 1).bit_length())
            if max_nnz else 0
        )
        # Bounded LRU of densified tiles: at most 256 MB of C tiles on the
        # device, so a streaming pass over a huge N never accumulates the
        # whole dense C.
        tile_bytes = self.tile_rows * self.v * torch.finfo(dtype).bits // 8
        self._max_cached = max(2, (256 << 20) // max(tile_bytes, 1))
        self._cache: dict[int, torch.Tensor] = {}  # insertion-ordered → LRU
        self._dense_c = None
        self._coo_dev = None
        self._pad_dev = None
        # f32 carries exact integers only to 2^24; refuse loudly. Cheap
        # bound first: c[i,v] <= colsum[v] gives rowsum_i <= Σ_v
        # colsum[v]². ``exact_counts=False`` waives the guard (PathSim
        # scores are invariant under C → αC, so f32 loses only rounding:
        # ~√V·2⁻²⁴ relative, ~1e-6 at V = 64), the million-author regime.
        if exact_counts and chain._is_float32(dtype):
            if float((colsum**2).sum()) >= chain.F32_EXACT_INT_MAX:
                self._check_exact_rowsums(dtype)

    def _check_exact_rowsums(self, dtype) -> None:
        """Tight per-row check, only run when the cheap bound trips."""
        from . import chain
        from . import packed as pkd

        rs = pkd.factor_rowsums_weighted(self._host_factor, self.colsum_total)
        chain.check_exact_counts(rs.max(initial=0.0), dtype)

    def _pad_cells(self):
        """The scatter pad's distinct cells (rows, cols) on the device,
        made once."""
        if self._pad_dev is None:
            pad = torch.arange(self._max_nnz, device=self.device)
            self._pad_dev = ((pad // self.v) % self.tile_rows, pad % self.v)
        return self._pad_dev

    def _device_coo(self):
        """(rows, cols, weights) of the sorted COO on the device, uploaded
        once (int64 indices, weights in the working dtype). COO factors
        only: a packed factor uploads one decoded tile span at a time."""
        if self._coo_dev is None:
            self._coo_dev = (
                torch.as_tensor(self._rows, dtype=torch.int64,
                                device=self.device),
                torch.as_tensor(self._cols, dtype=torch.int64,
                                device=self.device),
                torch.as_tensor(self._weights, device=self.device).to(
                    self.dtype),
            )
        return self._coo_dev

    def _tile_span_device(self, i: int):
        """Tile i's COO span on the device as (local rows, cols,
        weights): slices of the uploaded COO, or the transient decode of
        the packed chunks the span touches, uploaded."""
        r0 = i * self.tile_rows
        if self._packed is None:
            s, e = int(self._tile_start[i]), int(self._tile_stop[i])
            rows_d, cols_d, w_d = self._device_coo()
            return rows_d[s:e] - r0, cols_d[s:e], w_d[s:e]
        from . import packed as pkd

        span = pkd.row_slice(self._packed, r0, r0 + self.tile_rows)
        return (
            torch.as_tensor(span.rows - r0, dtype=torch.int64,
                            device=self.device),
            torch.as_tensor(span.cols, dtype=torch.int64,
                            device=self.device),
            torch.as_tensor(span.weights, device=self.device).to(self.dtype),
        )

    def tile(self, i: int) -> torch.Tensor:
        """Dense [tile_rows, V] tile i of C on the device (padded rows
        are zero)."""
        if i in self._cache:
            self._cache[i] = self._cache.pop(i)  # refresh LRU position
            return self._cache[i]
        pad_rows, pad_cols = self._pad_cells()
        t_rows, t_cols, t_w = self._tile_span_device(i)
        nnz = t_rows.shape[0]
        rows = pad_rows.clone()
        cols = pad_cols.clone()
        w = torch.zeros(self._max_nnz, dtype=self.dtype, device=self.device)
        rows[:nnz] = t_rows
        cols[:nnz] = t_cols
        w[:nnz] = t_w
        t = densify_tile(rows, cols, w, n_rows=self.tile_rows, n_cols=self.v)
        while len(self._cache) >= self._max_cached:
            self._cache.pop(next(iter(self._cache)))  # evict LRU
        self._cache[i] = t
        return t

    def dense_bytes(self) -> int:
        """Device bytes of the full padded dense C [n_tiles·tile_rows, V]."""
        return (self.n_tiles * self.tile_rows * self.v
                * torch.finfo(self.dtype).bits // 8)

    def dense_device(self) -> torch.Tensor:
        """The whole dense C on the device, scatter-assembled once from
        the COO factor (O(nnz) transfer; a packed factor decodes once,
        transiently). Outside the tile LRU's budget: callers gate on
        :meth:`dense_bytes` (268 MB at 1M authors, V = 64, f32)."""
        if self._dense_c is None:
            with get_tracer().span("backend.factor",
                                   device=self.device) as span:
                held = self.device_bytes() if span is not None else 0
                if self._packed is None:
                    rows, cols, w = self._device_coo()
                else:
                    from . import packed as pkd

                    coo = pkd.as_coo(self._packed)
                    rows = torch.as_tensor(coo.rows, dtype=torch.int64,
                                           device=self.device)
                    cols = torch.as_tensor(coo.cols, dtype=torch.int64,
                                           device=self.device)
                    w = torch.as_tensor(coo.weights, device=self.device).to(
                        self.dtype)
                self._dense_c = densify_tile(
                    rows, cols, w,
                    n_rows=self.n_tiles * self.tile_rows, n_cols=self.v,
                )
                if span is not None:
                    span.args["bytes"] = self.device_bytes() - held
        return self._dense_c

    def device_bytes(self) -> int:
        """Device bytes the chain holds: the uploaded COO, the scatter
        pad's cells, the cached tiles and the dense C."""
        held = [*(self._coo_dev or ()), *(self._pad_dev or ()),
                *self._cache.values()]
        if self._dense_c is not None:
            held.append(self._dense_c)
        return sum(t.nbytes for t in held)

    def drop_dense(self) -> None:
        """Release the cached dense C (a caller that holds its own copy
        in kernel form needs no second one); the next
        :meth:`dense_device` rebuilds it from the COO."""
        self._dense_c = None

    def rowsums(self) -> np.ndarray:
        """C @ colsum_total, one tile GEMV at a time, fetched once."""
        total = torch.as_tensor(self.colsum_total, device=self.device).to(
            self.dtype)
        out = torch.cat([tile_rowsums(self.tile(i), total)
                         for i in range(self.n_tiles)])
        return out[: self.n].cpu().double().numpy()

    def m_tile(self, i: int, j: int) -> torch.Tensor:
        return tile_outer(self.tile(i), self.tile(j))
