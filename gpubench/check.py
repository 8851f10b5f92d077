"""The comparison that decides ``correct``: the rows that the timed
rank-alls produced, held against the plain reference.

Which rows: a sample drawn from the seed (:func:`sample_rows`) with the
Zipf head (the lowest ids: the prolific authors, the multi-limb rows of
the factor), rows of the first row tile and of a middle one (K3's row
tiles at ``TILE`` rows), and rows from anywhere. Every call of the
window hands over those rows, and every call's rows are compared.

The number compared, ``rank_gap``, with its limit from the
configuration's ``limits`` (``PERF.md`` gives the readings it was set
from), is the widest of, over every rank of every sampled row of every
call:

- the value gap: |program − reference| between the two top-k values at
  that rank;
- the pick gap: the gap between the reference's value at that rank and
  the reference's score of the column the program chose there, so that
  a wrong column with a right value shows;

and it reads inf where a row breaks the (−score, column) order in the
program's own values (a value above the one before it, or an equal value
with a column not above the one before it), or holds a column out of
range, the row itself, or a column twice. The parts are returned beside
it, for the run's log.
"""

from __future__ import annotations

import numpy as np

# K3's row tile in the million-author configuration, and so the unit of
# the tiles the sample draws from
TILE = 8192
HEAD, IN_FIRST_TILE, IN_MIDDLE_TILE, ANYWHERE = 16, 48, 64, 128


def sample_rows(n: int, seed: int) -> np.ndarray:
    """The rows compared, sorted and distinct: the first ``HEAD`` rows,
    then rows drawn from ``seed`` in row tile 0, in the middle row tile
    and anywhere."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x9E37])
    tile = min(TILE, n)
    mid = (n // tile // 2) * tile
    parts = [
        np.arange(min(HEAD, n)),
        rng.integers(0, tile, IN_FIRST_TILE),
        rng.integers(mid, min(mid + tile, n), IN_MIDDLE_TILE),
        rng.integers(0, n, ANYWHERE),
    ]
    return np.unique(np.concatenate(parts))


def _order_faults(vals: np.ndarray, idxs: np.ndarray, rows: np.ndarray,
                  n: int) -> int:
    """Rows (of one [R, k] output) out of order or with a bad column."""
    v0, v1 = vals[:, :-1], vals[:, 1:]
    i0, i1 = idxs[:, :-1], idxs[:, 1:]
    unordered = ((v1 > v0) | ((v1 == v0) & (i1 <= i0))).any(axis=1)
    bad = ((idxs < 0) | (idxs >= n) | (idxs == rows[:, None])).any(axis=1)
    srt = np.sort(idxs, axis=1)
    repeat = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    return int((unordered | bad | repeat).sum())


def compare(outputs, rows: np.ndarray, reference, k: int, limits: dict,
            calls: int | None = None) -> tuple[dict, dict]:
    """Hold every call's sampled rows against ``reference`` (an object
    with ``n``, ``topk(rows, k)`` and ``scores(rows, cols)``).
    ``outputs`` is a list of (values [R, k], columns [R, k]): the
    distinct outputs of ``calls`` calls (one per call where ``calls`` is
    None); identical outputs are compared once. Returns the checks,
    ``{"rank_gap": {"value", "limit"}}``, and the parts: the value and
    pick gaps, the rows with order faults, the calls and the distinct
    outputs among them."""
    n = reference.n
    ref_v, _ = reference.topk(rows, k)
    distinct = {}
    for v, i in outputs:
        distinct.setdefault(v.tobytes() + i.tobytes(), (v, i))
    value_gap = pick_gap = 0.0
    faults = 0
    for v, i in distinct.values():
        v = np.asarray(v, dtype=np.float64)
        i = np.asarray(i, dtype=np.int64)
        if v.shape != ref_v.shape or i.shape != ref_v.shape:
            value_gap = pick_gap = float("inf")
            faults += rows.size
            continue
        value_gap = max(value_gap, _widest(v, ref_v))
        valid = (i >= 0) & (i < n) & (i != rows[:, None])
        s = np.full(i.shape, -np.inf)
        r2 = np.broadcast_to(rows[:, None], i.shape)
        s[valid] = reference.scores(r2[valid], i[valid])
        s[~valid] = np.nan
        pick_gap = max(pick_gap, _widest(s, ref_v))
        faults += _order_faults(v, i, rows, n)
    gap = float("inf") if faults else max(value_gap, pick_gap)
    parts = {"value_gap": value_gap, "pick_gap": pick_gap,
             "order_faults": faults,
             "calls": len(outputs) if calls is None else calls,
             "distinct": len(distinct)}
    return {"rank_gap": {"value": gap, "limit": limits["rank_gap"]}}, parts


def _widest(a: np.ndarray, ref: np.ndarray) -> float:
    """The widest |a − ref|; equal infinities read 0, a NaN reads inf."""
    with np.errstate(invalid="ignore"):
        gap = np.where(a == ref, 0.0, np.abs(a - ref))
    return float(np.nan_to_num(gap, nan=np.inf, posinf=np.inf).max(
        initial=0.0))


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
