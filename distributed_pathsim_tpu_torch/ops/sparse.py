"""Sparse half-chain machinery: host COO folding + the two-pass top-k's
second pass.

The *structure* of the half-chain product — which (source, venue)-style
pairs exist — is a sort/searchsorted join on the host (O(nnz log nnz),
numpy); the *numbers* — duplicate accumulation, row sums, score tiles —
run on the device. This replaces the reference's per-query 4-way
distributed hash join with one precomputed join reused by every query,
and it never builds a P×V or N×N dense intermediate.

:func:`chunked_row_topk` is the exact hierarchical top-k that reduces
the CUDA candidate kernel's per-tile winners to each row's final top-k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
    """One coalesced COO product (row-major sorted, exact integer
    accumulation in f64)."""
    return coo_matmul(a, b).summed()


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
