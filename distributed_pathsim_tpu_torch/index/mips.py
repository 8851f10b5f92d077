"""Capacity-balanced k-means: the row grouping of the batch tier's
``simjoin --grouping centroid``.

The port's copy of the part of the JAX package's ``index/mips.py`` that
the similarity join needs (host numpy, unchanged in behavior). The
centroid MIPS index itself (the ANN serving lane) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def balanced_kmeans(
    emb: np.ndarray, k: int, cap: int, iters: int = 10, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Capacity-constrained Lloyd iterations: every round runs a
    capacity-bounded assignment (closest nodes win the seats; overflow
    spills down each node's centroid-preference list) and recomputes
    centroids from the members a cluster ACTUALLY holds. Plain k-means
    + post-hoc capping failed measurably here: skewed-norm embedding
    corpora collapse into one mega-cluster whose capped overflow lands
    far from any centroid that describes it, and probe routing (top
    nprobe by query·centroid) then misses true top-k targets outright
    (recall@10 0.88 → 0.96 at nprobe=8, → 1.00 at 16, on the
    2048-author gate graph). Returns (centroids [K, D], assign [N])."""
    emb = np.asarray(emb, dtype=np.float32)
    n = emb.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centroids = emb[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(max(iters, 1)):
        assign = _balanced_assign(emb, centroids, cap)
        for kk in range(k):
            m = assign == kk
            if m.any():
                centroids[kk] = emb[m].mean(axis=0)
    return centroids, assign


def _balanced_assign(
    emb: np.ndarray, centroids: np.ndarray, cap: int, width: int = 8
) -> np.ndarray:
    """One capacity-bounded assignment pass: nodes claim seats in
    order of distance to their preferred centroid (closest first), each
    taking its best centroid with space; preference-list exhaustion
    falls back to any open cluster. K·cap ≥ N is the caller's
    feasibility contract."""
    n, k = emb.shape[0], centroids.shape[0]
    prefs = _pref_lists(emb, centroids, width=min(width, k))
    c2 = (centroids * centroids).sum(axis=1)
    d0 = c2[prefs[:, 0]] - 2.0 * np.einsum(
        "nd,nd->n", emb, centroids[prefs[:, 0]]
    )
    assign = np.full(n, -1, dtype=np.int64)
    fill = np.zeros(k, dtype=np.int64)
    for node in np.argsort(d0, kind="stable"):
        for r in range(prefs.shape[1]):
            c = prefs[node, r]
            if fill[c] < cap:
                assign[node] = c
                fill[c] += 1
                break
    unplaced = np.flatnonzero(assign < 0)
    if unplaced.size:
        open_c = np.flatnonzero(fill < cap)
        oi = 0
        for node in unplaced:
            while fill[open_c[oi]] >= cap:
                oi += 1
            assign[node] = open_c[oi]
            fill[open_c[oi]] += 1
    return assign


def _pref_lists(
    emb: np.ndarray, centroids: np.ndarray, width: int, chunk: int = 16384
) -> np.ndarray:
    """Each node's ``width`` nearest centroids, nearest first."""
    n, k = emb.shape[0], centroids.shape[0]
    width = min(width, k)
    prefs = np.empty((n, width), dtype=np.int64)
    c2 = (centroids * centroids).sum(axis=1)[None, :]
    for lo in range(0, n, chunk):
        block = emb[lo:lo + chunk]
        d2 = c2 - 2.0 * (block @ centroids.T)
        part = np.argpartition(d2, width - 1, axis=1)[:, :width]
        order = np.take_along_axis(d2, part, axis=1).argsort(axis=1)
        prefs[lo:lo + chunk] = np.take_along_axis(part, order, axis=1)
    return prefs
