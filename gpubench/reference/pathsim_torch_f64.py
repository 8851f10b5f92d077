"""The plain reference in PyTorch: PathSim top-k over the APVPA metapath
in float64 on the CPU, from the graph's edges.

    C = A_AP · A_PV                (authors × venues path counts)
    M = C · Cᵀ                     (APVPA path counts)
    d = M · 1 = C · (Cᵀ · 1)       (each author's global walks)
    s(i, j) = 2 M[i, j] / (d_i + d_j), 0 where d_i + d_j = 0

A row's top-k leaves out the self pair and is ordered by (−score,
column): ties go to the lower column. Every count is an integer below
2^53, so C, M and d are exact in float64, and each score is the correctly
rounded quotient: the upstream's ``2*pw/(gs+gt)`` as a Python float. The
same function as ``pathsim_f64`` (NumPy), written in plain torch
operations. Nothing here imports the port or JAX: C and d are worked out
again from the edges, not taken from the program.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_long(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int64))


class PathSimTorchF64:
    """C and d of one graph, and the top-k of any rows against every
    column. Rows go through in blocks, so that M is never held whole."""

    # scores of one block of rows
    BLOCK_SCORES = 1 << 23

    def __init__(self, ap_rows, ap_cols, pv_rows, pv_cols, n_authors: int,
                 n_papers: int, n_venues: int):
        ap_rows, ap_cols = _as_long(ap_rows), _as_long(ap_cols)
        pv_rows, pv_cols = _as_long(pv_rows), _as_long(pv_cols)
        # C[a, v] counts the (a, p, v) paths: each author-paper edge once
        # for every venue edge of its paper
        venue_of = pv_cols[torch.argsort(pv_rows, stable=True)]
        deg = torch.bincount(pv_rows, minlength=n_papers)
        start = torch.cumsum(deg, 0) - deg
        reps = deg[ap_cols]
        a = torch.repeat_interleave(ap_rows, reps)
        first = torch.repeat_interleave(start[ap_cols], reps)
        within = torch.arange(a.numel()) - torch.repeat_interleave(
            torch.cumsum(reps, 0) - reps, reps)
        v = venue_of[first + within]
        self.c = torch.bincount(a * n_venues + v,
                                minlength=n_authors * n_venues).view(
            n_authors, n_venues).to(torch.float64)
        self.d = self.c @ self.c.sum(0)
        self.n = n_authors

    def _score_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """s(rows, :) as [len(rows), N] float64, the self pairs −inf.
        M[i, j] is 0 wherever d_i + d_j is (both rows of C are empty),
        and d is integer-valued, so dividing by max(d_i + d_j, 1) gives
        the 0 that the definition asks for and leaves the rest exact."""
        m = self.c[rows] @ self.c.T
        m *= 2.0
        m /= torch.clamp(self.d[rows, None] + self.d[None, :], min=1.0)
        m[torch.arange(rows.numel()), rows] = -torch.inf
        return m

    @staticmethod
    def _row_topk(s: torch.Tensor, k: int):
        """Top-k of one score row by (−score, column)."""
        thr = torch.topk(s, k).values[-1]  # the k-th largest score
        above = torch.nonzero(s > thr).flatten()
        above = above[torch.sort(-s[above], stable=True).indices]
        ties = torch.nonzero(s == thr).flatten()[: k - above.numel()]
        idx = torch.cat([above, ties])
        return s[idx], idx

    def topk(self, rows, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(values [R, k] float64, columns [R, k] int64) of ``rows``,
        k clamped to N − 1 as the port clamps it."""
        rows = _as_long(rows)
        k = min(k, self.n - 1)
        step = max(1, self.BLOCK_SCORES // self.n)
        vals, idxs = [], []
        for b0 in range(0, rows.numel(), step):
            for s in self._score_rows(rows[b0:b0 + step]):
                v, i = self._row_topk(s, k)
                vals.append(v)
                idxs.append(i)
        if not vals:
            return np.empty((0, k)), np.empty((0, k), dtype=np.int64)
        return torch.stack(vals).numpy(), torch.stack(idxs).numpy()

    def scores(self, rows, cols) -> np.ndarray:
        """s(rows[i], cols[i]) for each i (arrays of one shape): float64,
        −inf at a self pair."""
        shape = np.shape(rows)
        r, c = _as_long(rows).flatten(), _as_long(cols).flatten()
        m = (self.c[r] * self.c[c]).sum(1)
        s = 2.0 * m / torch.clamp(self.d[r] + self.d[c], min=1.0)
        s[r == c] = -torch.inf
        return s.numpy().reshape(shape)


def from_graph(g: dict) -> PathSimTorchF64:
    """The reference of a graph as :func:`gpubench.graph.synthetic_coo`
    returns it."""
    return PathSimTorchF64(g["ap_rows"], g["ap_cols"], g["pv_rows"],
                           g["pv_cols"], g["authors"], g["papers"],
                           g["venues"])
