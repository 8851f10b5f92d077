"""The plain reference: PathSim top-k over the APVPA metapath in NumPy
float64, from the graph's edges.

    C = A_AP · A_PV                (authors × venues path counts)
    M = C · Cᵀ                     (APVPA path counts)
    d = M · 1 = C · (Cᵀ · 1)       (each author's global walks)
    s(i, j) = 2 M[i, j] / (d_i + d_j), 0 where d_i + d_j = 0

A row's top-k leaves out the self pair and is ordered by (−score,
column): ties go to the lower column. Every count is an integer below
2^53, so C, M and d are exact in float64, and each score is the correctly
rounded quotient. Nothing here imports the port or JAX: C and d are
worked out again from the edges, not taken from the program.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class PathSimF64:
    """C and d of one graph, and the top-k of any rows against every
    column. Rows go through in blocks, so that M is never held whole, on
    a few threads (NumPy lets go of the interpreter lock in its loops)."""

    # scores of one block of rows
    BLOCK_SCORES = 1 << 23
    THREADS = min(8, os.cpu_count() or 1)

    def __init__(self, ap_rows, ap_cols, pv_rows, pv_cols, n_authors: int,
                 n_papers: int, n_venues: int):
        ap_rows = np.asarray(ap_rows, dtype=np.int64)
        ap_cols = np.asarray(ap_cols, dtype=np.int64)
        pv_rows = np.asarray(pv_rows, dtype=np.int64)
        pv_cols = np.asarray(pv_cols, dtype=np.int64)
        # C[a, v] counts the (a, p, v) paths: each author-paper edge once
        # for every venue edge of its paper
        order = np.argsort(pv_rows, kind="stable")
        venue_of = pv_cols[order]
        deg = np.bincount(pv_rows, minlength=n_papers)
        start = np.concatenate([[0], np.cumsum(deg)[:-1]])
        reps = deg[ap_cols]
        a = np.repeat(ap_rows, reps)
        first = np.repeat(start[ap_cols], reps)
        within = np.arange(a.size) - np.repeat(np.cumsum(reps) - reps, reps)
        v = venue_of[first + within]
        self.c = np.bincount(a * n_venues + v, minlength=n_authors * n_venues
                             ).reshape(n_authors, n_venues).astype(np.float64)
        self.d = self.c @ self.c.sum(0)
        self.n = n_authors

    def _score_rows(self, rows: np.ndarray) -> np.ndarray:
        """s(rows, :) as [len(rows), N] float64, the self pairs −inf.
        M[i, j] is 0 wherever d_i + d_j is (both rows of C are empty),
        and d is integer-valued, so dividing by max(d_i + d_j, 1) gives
        the 0 that the definition asks for and leaves the rest exact."""
        m = self.c[rows] @ self.c.T
        m *= 2.0
        m /= np.maximum(self.d[rows, None] + self.d[None, :], 1.0)
        m[np.arange(rows.size), rows] = -np.inf
        return m

    @staticmethod
    def _row_topk(s: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of one score row by (−score, column)."""
        n = s.size
        thr = np.partition(s, n - k)[n - k]  # the k-th largest score
        above = np.flatnonzero(s > thr)
        above = above[np.lexsort((above, -s[above]))]
        ties = np.flatnonzero(s == thr)[: k - above.size]
        idx = np.concatenate([above, ties])
        return s[idx], idx

    def topk(self, rows, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(values [R, k] float64, columns [R, k] int64) of ``rows``,
        k clamped to N − 1 as the port clamps it."""
        rows = np.asarray(rows, dtype=np.int64)
        k = min(k, self.n - 1)
        step = max(1, self.BLOCK_SCORES // self.n)
        blocks = [rows[b0:b0 + step] for b0 in range(0, rows.size, step)]

        def block_topk(block):
            out = [self._row_topk(s, k) for s in self._score_rows(block)]
            return [v for v, _ in out], [i for _, i in out]

        vals, idxs = [], []
        with ThreadPoolExecutor(self.THREADS) as pool:
            for v, i in pool.map(block_topk, blocks):
                vals += v
                idxs += i
        return (np.array(vals).reshape(rows.size, k),
                np.array(idxs, dtype=np.int64).reshape(rows.size, k))

    def scores(self, rows, cols) -> np.ndarray:
        """s(rows[i], cols[i]) for each i (arrays of one shape): float64,
        −inf at a self pair."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        r, c = rows.ravel(), cols.ravel()
        m = np.einsum("ij,ij->i", self.c[r], self.c[c])
        s = 2.0 * m / np.maximum(self.d[r] + self.d[c], 1.0)
        s[r == c] = -np.inf
        return s.reshape(rows.shape)


def from_graph(g: dict) -> PathSimF64:
    """The reference of a graph as :func:`gpubench.graph.synthetic_coo`
    returns it."""
    return PathSimF64(g["ap_rows"], g["ap_cols"], g["pv_rows"], g["pv_cols"],
                      g["authors"], g["papers"], g["venues"])
