"""Online exact-teacher distillation into serving towers.

The trainer promotes ``models/neural.py``'s two-tower machinery into
the serving tier's model producer. Distillation has two teachers, both
exact:

- **hard-candidate mining** — the exact engine's own top-k lists for a
  pool of sources (``NeuralPathSim.mine_hard_candidates``, on the
  device): the slates the serving ordering is actually decided on;
- **the batch tier's ``--emit-pairs`` stream** — campaign-computed
  exact (row, col, score) hits (``batch/pairs.py`` schema). Their rows
  join the hard pool, and a seeded BY-SOURCE validation split reports
  distillation quality on sources the pool never drew.

The output is an :class:`~.encoder.InductiveEncoder` (numpy towers +
pinned constants) plus a training-info dict; :func:`train_towers`
writes the fingerprint-keyed checkpoint when asked. The JAX package's
``learned/trainer.py``, with the tower trained on ``device`` (None: the
card).
"""

from __future__ import annotations

import time

import numpy as np

from ..utils.logging import runtime_event
from .checkpoint import save_towers
from .encoder import InductiveEncoder


def _pairs_to_pool(
    rows: np.ndarray, cols: np.ndarray, scores: np.ndarray,
    n: int, width: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Group emitted pairs by source into a rectangular hard pool
    [T, width] (per-source candidates, best score first; short rows
    cycle their own candidates — slate sampling draws with replacement
    anyway). Out-of-range rows are dropped: a pairs file from a larger
    graph must not crash training on a subset."""
    keep = (rows < n) & (cols < n)
    rows, cols, scores = rows[keep], cols[keep], scores[keep]
    if not rows.size:
        return np.empty(0, np.int64), np.empty((0, width), np.int64)
    order = np.lexsort((-scores, rows))
    rows, cols = rows[order], cols[order]
    uniq, starts = np.unique(rows, return_index=True)
    bounds = np.append(starts, len(rows))
    pool = np.empty((len(uniq), width), dtype=np.int64)
    for t, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        pool[t] = np.resize(cols[lo:hi], width)
    return uniq.astype(np.int64), pool


def train_towers(
    hin,
    metapath,
    *,
    variant: str = "rowsum",
    dim: int = 32,
    hidden: int = 64,
    steps: int = 200,
    batch_size: int = 512,
    lr: float = 1e-3,
    seed: int = 0,
    hard_frac: float | None = None,
    hard_sources: int = 512,
    hard_k: int = 32,
    pairs: str | None = None,
    val_frac: float = 0.1,
    token: tuple[str, int] | None = None,
    out: str | None = None,
    mesh=None,
    device=None,
) -> tuple[InductiveEncoder, dict]:
    """Distill the exact engine into serving towers for ``hin``.

    ``pairs`` is an ``--emit-pairs`` JSONL path (optional); ``token``
    is the serving consistency token the checkpoint is keyed to
    (default: the graph fingerprint at delta_seq 0 — the same identity
    ``dpathsim-torch index build`` stamps). ``out`` writes the
    checkpoint. ``device`` is where the tower trains and mining runs
    (None: CUDA). Returns ``(encoder, info)``.
    """
    from ..models.neural import NeuralPathSim
    from ..serving.cache import graph_fingerprint

    t0 = time.perf_counter()
    model = NeuralPathSim(
        hin, metapath, dim=dim, hidden=hidden, lr=lr, seed=seed,
        variant=variant, mesh=mesh, device=device,
    )
    if hard_frac is not None:
        # per-instance override of the slate mix (the tuned
        # learned_neg_ratio knob arrives here as 1 - neg_ratio)
        model.HARD_FRAC = float(hard_frac)
    info: dict = {
        "n": model.n, "v": model.v, "dim": dim, "hidden": hidden,
        "steps": steps, "seed": seed, "variant": model.variant,
        "metapath": model.metapath.name,
    }

    # -- teacher 1: exact-engine hard mining ------------------------------
    pool_src = np.empty(0, np.int64)
    pool_cand = np.empty((0, min(hard_k, max(model.n - 1, 1))), np.int64)
    if model.n >= 2 and hard_sources > 0:
        pool_src, pool_cand = model.mine_hard_candidates(
            min(hard_sources, model.n), k=hard_k, seed=seed
        )

    # -- teacher 2: the batch tier's --emit-pairs stream ------------------
    val = None
    if pairs is not None:
        from ..batch.pairs import load_pairs, split_pairs

        p_rows, p_cols, p_scores = load_pairs(pairs)
        train_mask, val_mask = split_pairs(
            p_rows, val_frac=val_frac, seed=seed
        )
        info["pairs_total"] = int(p_rows.size)
        info["pairs_val"] = int(val_mask.sum())
        if val_mask.any():
            val = (p_rows[val_mask], p_cols[val_mask], p_scores[val_mask])
        extra_src, extra_cand = _pairs_to_pool(
            p_rows[train_mask], p_cols[train_mask], p_scores[train_mask],
            model.n, pool_cand.shape[1],
        )
        # campaign rows REPLACE mined rows on collision (the campaign's
        # lists are full exact top-k; mining may have sampled fewer)
        if extra_src.size:
            keep = ~np.isin(pool_src, extra_src)
            pool_src = np.concatenate([pool_src[keep], extra_src])
            pool_cand = np.concatenate([pool_cand[keep], extra_cand])

    if pool_src.size:
        model.set_hard_pool(pool_src, pool_cand)
    info["hard_pool"] = int(pool_src.size)

    losses = model.train(steps=steps, batch_size=batch_size, seed=seed)
    info["final_loss"] = round(float(losses[-1]), 6) if losses else None

    # -- distillation quality on the held-out sources ---------------------
    if val is not None:
        vr, vc, vs = val
        keep = (vr < model.n) & (vc < model.n)
        vr, vc, vs = vr[keep], vc[keep], vs[keep]
        if vr.size >= 2:
            pred = model.predict_pairs(vr, vc)
            # Pearson corr of the tower's raw prediction against the
            # exact score over the held-out pairs
            vsn = vs - vs.mean()
            pn = pred - pred.mean()
            denom = float(np.linalg.norm(vsn) * np.linalg.norm(pn))
            info["val_score_corr"] = (
                round(float(vsn @ pn) / denom, 4) if denom > 0 else None
            )

    encoder = InductiveEncoder.from_model(
        model, meta={"steps": int(steps), "seed": int(seed)}
    )
    if token is None:
        token = (graph_fingerprint(hin), 0)
    info["token"] = list(token)
    info["train_s"] = round(time.perf_counter() - t0, 3)
    if out is not None:
        save_towers(out, encoder, token)
        info["out"] = out
    runtime_event("learned_train_done", echo=False, **{
        k: v for k, v in info.items() if k != "token"
    })
    return encoder, info
