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


def device_counts(a: np.ndarray, b_dev) -> np.ndarray:
    """``a @ b`` in float64 on the card that holds ``b_dev`` (a torch
    tensor), fetched to the host: the device arm of the exact counts.
    The card's f64 is IEEE f64 and every count is an exact integer below
    2^53, so the product is bit-identical to numpy's under any
    association order."""
    import torch

    a_dev = torch.as_tensor(a, dtype=torch.float64).to(b_dev.device,
                                                       non_blocking=True)
    return torch.matmul(a_dev, b_dev).cpu().numpy()


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


def score_candidates(m_cand, d_sources, d_cand, xp: Any = np):
    """Candidate-restricted :func:`score_rows`: ``m_cand`` [B, C] holds
    the pairwise counts for an explicit candidate-column set, ``d_cand``
    [B, C] those columns' denominators. Entry-for-entry the same f64
    arithmetic as the full-row call, so a candidate scored here is
    bit-identical to its column in ``score_rows`` — the ANN serving
    path's exact-rerank contract rests on that."""
    denom = d_sources[:, None] + d_cand
    return xp.where(denom > 0, 2.0 * m_cand / xp.where(denom > 0, denom, 1), 0.0)


def topk_from_candidate_scores(scores: np.ndarray, cols: np.ndarray, k: int):
    """Top-k over an explicit candidate set with the oracle tie order.

    ``scores`` f64 [B, C] and ``cols`` int64 [B, C] give each
    candidate's score and GLOBAL column index; entries with ``cols < 0``
    are padding and never returned. Ordering is (descending score,
    ascending global column) — the :func:`topk_from_score_rows` order
    restricted to the candidate set, so whenever the true top-k is a
    subset of the candidates the result is bit-identical to the
    full-row call, boundary ties included. Duplicated candidate columns
    are deduplicated (they carry identical scores by construction).
    Returns (values f64 [B, k], indices int64 [B, k]), short rows
    padded with (−inf, 0) exactly like the full-row primitive."""
    b = scores.shape[0]
    vals = np.full((b, k), -np.inf)
    idxs = np.zeros((b, k), dtype=np.int64)
    for i in range(b):
        keep = cols[i] >= 0
        c, s = cols[i][keep], scores[i][keep]
        if c.size == 0:
            continue
        if c.size > k:
            # O(C) partition to the k-boundary first — the sort and
            # dedup then touch only the boundary's tie set, not all C
            # candidates (the same trick topk_from_score_rows uses);
            # every score tied with the k-th is kept, so boundary tie
            # order is exact
            kth = -np.partition(-s, k - 1)[k - 1]
            top = s >= kth
            ct, st = c[top], s[top]
            cu, first = np.unique(ct, return_index=True)
            if cu.shape[0] >= k or ct.shape[0] == c.shape[0]:
                c, s = cu, st[first]
            else:
                # duplicated columns ate the partition's k guarantee:
                # fall back to deduping the full candidate list
                c, first = np.unique(c, return_index=True)
                s = s[first]
        else:
            c, first = np.unique(c, return_index=True)
            s = s[first]
        order = np.lexsort((c, -s))[:k]
        vals[i, : order.shape[0]] = s[order]
        idxs[i, : order.shape[0]] = c[order]
    return vals, idxs


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
