"""The ``--emit-pairs`` JSONL contract: loader, split, negatives.

Schema (one JSON object per line, written by
:func:`~.campaign.export_pairs` and the simjoin runner — DESIGN.md
§31a):

- ``row``   int ≥ 0 — source node's dense row index;
- ``col``   int ≥ 0 — neighbor's dense row index (never == row);
- ``score`` finite float — the EXACT PathSim score of the pair, JSON
  shortest-repr so the f64 bytes round-trip exactly.

Unknown keys are rejected loudly: a producer drifting the schema must
fail the consumer's load, not silently train on half a record. These
helpers are the learned tier's data plumbing (the trainer distills
from this stream), kept in batch/ because the schema belongs to the
producer.
"""

from __future__ import annotations

import json

import numpy as np

PAIRS_FIELDS = ("row", "col", "score")


def load_pairs(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read an ``--emit-pairs`` JSONL file → ``(rows, cols, scores)``
    (int64, int64, f64). Validates the schema per line with the line
    number in every error."""
    rows: list[int] = []
    cols: list[int] = []
    scores: list[float] = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(
                    f"{path}:{lineno}: not JSON ({exc})"
                ) from exc
            if not isinstance(rec, dict) or set(rec) != set(PAIRS_FIELDS):
                raise ValueError(
                    f"{path}:{lineno}: expected exactly the fields "
                    f"{PAIRS_FIELDS}, got "
                    f"{sorted(rec) if isinstance(rec, dict) else rec!r}"
                )
            r, c, s = rec["row"], rec["col"], rec["score"]
            if not (isinstance(r, int) and isinstance(c, int)) or (
                isinstance(r, bool) or isinstance(c, bool)
            ):
                raise ValueError(
                    f"{path}:{lineno}: row/col must be integers"
                )
            if r < 0 or c < 0:
                raise ValueError(
                    f"{path}:{lineno}: negative node index ({r}, {c})"
                )
            s = float(s)
            if not np.isfinite(s):
                raise ValueError(
                    f"{path}:{lineno}: non-finite score {s!r}"
                )
            rows.append(r)
            cols.append(c)
            scores.append(s)
    return (
        np.asarray(rows, dtype=np.int64),
        np.asarray(cols, dtype=np.int64),
        np.asarray(scores, dtype=np.float64),
    )


def split_pairs(
    rows: np.ndarray, val_frac: float = 0.1, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Seeded, deterministic train/val split BY SOURCE ROW: every pair
    of one source lands on the same side, so validation measures
    ranking on sources the tower's hard-pool slates never drew — the
    honest distillation-quality number. Returns boolean masks
    ``(train_mask, val_mask)`` over the pair arrays."""
    rows = np.asarray(rows)
    if not 0.0 <= val_frac < 1.0:
        raise ValueError(f"val_frac must be in [0, 1), got {val_frac}")
    uniq = np.unique(rows)
    n_val = int(round(len(uniq) * val_frac))
    rng = np.random.default_rng(seed)
    val_sources = rng.permutation(uniq)[:n_val]
    val_mask = np.isin(rows, val_sources)
    return ~val_mask, val_mask


def sample_negatives(
    rows: np.ndarray,
    cols: np.ndarray,
    n_nodes: int,
    ratio: float = 1.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Draw ``ratio × len(rows)`` uniform negative pairs that collide
    with neither the positive set nor the diagonal. Deterministic for
    a seed; resampling is bounded (collisions are resampled a fixed
    number of rounds, then dropped — on a tiny dense graph the
    negative pool can be genuinely exhausted)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if n_nodes < 2:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    want = int(round(len(rows) * ratio))
    seen = set(zip(rows.tolist(), cols.tolist()))
    rng = np.random.default_rng(seed)
    out_r: list[int] = []
    out_c: list[int] = []
    for _ in range(8):  # bounded resampling
        need = want - len(out_r)
        if need <= 0:
            break
        nr = rng.integers(0, n_nodes, size=need)
        nc = rng.integers(0, n_nodes, size=need)
        for r, c in zip(nr.tolist(), nc.tolist()):
            if r == c or (r, c) in seen:
                continue
            seen.add((r, c))
            out_r.append(r)
            out_c.append(c)
    return (
        np.asarray(out_r, dtype=np.int64),
        np.asarray(out_c, dtype=np.int64),
    )
