"""PathSim score normalization.

The reference's score (``DPathSim_APVPA.py:51-52``) is the *row-sum
variant*: sim(x,y) = 2·M[x,y] / (Σ_z M[x,z] + Σ_z M[y,z]), because its
"global walk" motif leaves ``author_2`` unconstrained (SURVEY.md §3.3 —
verified to the last digit against the reference's run log). The textbook
PathSim of Sun et al. normalizes by the diagonal instead:
sim(x,y) = 2·M[x,y] / (M[x,x] + M[y,y]). Both variants are provided;
``variant="rowsum"`` is the default and the parity target.

Degenerate denominators: with integer path counts, denom == 0 implies
M[x,y] == 0 (the numerator is bounded by either row sum); the reference
would raise ZeroDivisionError there (plain Python division). We define
the score as 0.0 in that case — the only semantic divergence, and only
on inputs that crash the reference.
"""

from __future__ import annotations

from typing import Any

import numpy as np

VARIANTS = ("rowsum", "diagonal")


def _denominators(m, rowsums, variant: str, xp: Any):
    if variant == "rowsum":
        if rowsums is None:
            rowsums = xp.sum(m, axis=1)
        return rowsums
    if variant == "diagonal":
        return xp.diagonal(m)
    raise ValueError(f"unknown PathSim variant {variant!r}; choose {VARIANTS}")


def score_matrix(m, rowsums=None, variant: str = "rowsum", xp: Any = np):
    """All-pairs scores: sim = 2·M / (d[:, None] + d[None, :])."""
    d = _denominators(m, rowsums, variant, xp)
    denom = d[:, None] + d[None, :]
    return xp.where(denom > 0, 2.0 * m / xp.where(denom > 0, denom, 1), 0.0)


def score_row(m_row, d_source, d, xp: Any = np):
    """Scores from one source against all targets, given its pairwise row
    ``m_row = M[s, :]`` and the denominator vector ``d``."""
    denom = d_source + d
    return xp.where(denom > 0, 2.0 * m_row / xp.where(denom > 0, denom, 1), 0.0)


def score_rows(m_rows, d_sources, d, xp: Any = np):
    """Batched :func:`score_row`: ``m_rows`` [B, N], ``d_sources`` [B].

    Same arithmetic per row (broadcast in place of the scalar), so a row
    scored here is bit-identical to the unbatched call — the serving
    layer's coalesced dispatch depends on that."""
    denom = d_sources[:, None] + d[None, :]
    return xp.where(denom > 0, 2.0 * m_rows / xp.where(denom > 0, denom, 1), 0.0)


def topk_from_score_rows(scores: np.ndarray, k: int):
    """Host top-k over score rows with the oracle tie order.

    ``scores`` is f64 [B, N] with excluded entries (self pairs) already
    −inf. Returns (values f64 [B, k], indices int64 [B, k]) ordered by
    (descending score, ascending column) — exactly
    ``np.argsort(-row, kind="stable")[:k]``, the driver/oracle order —
    but via an O(N) partition plus a sort over only the candidate set
    (every column tied with the k-th value is kept as a candidate, so
    boundary ties order identically to the full sort)."""
    b, n = scores.shape
    k = min(k, n)
    vals = np.full((b, k), -np.inf)
    idxs = np.zeros((b, k), dtype=np.int64)
    for i in range(b):
        s = scores[i]
        if k >= n:
            order = np.lexsort((np.arange(n), -s))[:k]
        else:
            kth = -np.partition(-s, k - 1)[k - 1]
            # kth == −inf (fewer than k finite scores) keeps every
            # column: −inf >= −inf, so the candidate set is complete.
            cand = np.nonzero(s >= kth)[0]
            order = cand[np.lexsort((cand, -s[cand]))[:k]]
        vals[i, : order.shape[0]] = s[order]
        idxs[i, : order.shape[0]] = order
    return vals, idxs
