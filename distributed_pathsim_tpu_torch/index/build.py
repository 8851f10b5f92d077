"""Graph → MIPS index: embedding maps and the build pipeline.

The embedding source is inner-product-faithful to the exact score:

- ``struct`` (default, no training): the analytic Cauchy-quadrature
  map φ(j) = vec_k(√(2·w_k)·e^(−d_j·t_k)·C_j) from models/neural.py —
  φ(i)·φ(j) ≈ 2·(C_i·C_j)/(d_i+d_j) to the quadrature's uniform ~3–7%
  relative error, which is ranking-grade. Its raw width is m·V; past
  ``max_dim`` a seeded Gaussian (JL) projection compresses it — inner
  products are preserved in expectation and the serving layer's
  shadow-recall gate measures what actually survived.
- ``learned``: a trained :class:`~..models.neural.NeuralPathSim`
  checkpoint's two-tower embeddings (O(d) with d≪m·V; a checkpoint of
  either package), the tower run on the build's device.

Everything else here is host numpy, as in the JAX package's
``index/build.py``, so a port struct build equals a JAX build array
for array.
Centroid count and cluster cap resolve through the tuning registry
(``ann_centroids``, ``ann_cluster_cap``) with the documented heuristics
as defaults.
"""

from __future__ import annotations

import numpy as np

from ..models.neural import QUAD_M, cauchy_quadrature, quadrature_gates
from ..utils.logging import runtime_event
from .mips import CentroidIndex

# quadrature width of the struct map — the trainer's own constant, so
# a widened grid there widens index builds with it
_QUAD_M = QUAD_M


def half_chain_and_denominators(
    hin, metapath, variant: str = "rowsum"
) -> tuple[np.ndarray, np.ndarray]:
    """Dense half-chain factor C [N, V] (f64, exact integer counts) and
    the denominator vector of ``variant`` — the two host arrays both
    the index build and the exact candidate rerank read."""
    from ..ops import planner

    c = planner.dense_half(hin, metapath).astype(np.float64)
    if variant == "rowsum":
        d = c @ c.sum(axis=0)
    elif variant == "diagonal":
        d = np.einsum("nv,nv->n", c, c)
    else:
        raise ValueError(f"unknown PathSim variant {variant!r}")
    return c, d


def struct_embeddings(
    c: np.ndarray,
    d: np.ndarray,
    quad: tuple[np.ndarray, np.ndarray] | None = None,
    quad_m: int = _QUAD_M,
    max_dim: int = 1024,
    seed: int = 0,
    chunk: int = 8192,
) -> np.ndarray:
    """The analytic Cauchy map φ [N, min(m·V, max_dim)] (f32). Chunked
    over rows so the unprojected [chunk, m·V] block is the largest
    intermediate even when a projection is active.

    ``quad`` (nodes t, weights w) pins the quadrature grid: φ vectors
    are only mutually inner-product-consistent when embedded on ONE
    grid, so a row refresh against an existing index must pass the
    grid (and projection seed) the index was built with — the build
    persists both in ``meta``."""
    c32 = np.asarray(c, dtype=np.float32)
    n, v = c32.shape
    t, w = quad if quad is not None else cauchy_quadrature(d, m=quad_m)
    t = np.asarray(t, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    quad_m = int(t.shape[0])
    gates = quadrature_gates(d, t)
    scale = np.sqrt(2.0 * w).astype(np.float32)
    full_dim = quad_m * v
    proj = None
    if full_dim > max_dim:
        rng = np.random.default_rng(seed)
        proj = (
            rng.standard_normal((full_dim, max_dim)) / np.sqrt(max_dim)
        ).astype(np.float32)
    out = np.empty((n, max_dim if proj is not None else full_dim),
                   dtype=np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        phi = (
            scale[None, :, None]
            * gates[lo:hi, :, None]
            * c32[lo:hi, None, :]
        ).reshape(hi - lo, full_dim)
        out[lo:hi] = phi if proj is None else phi @ proj
    return out


def learned_embeddings(model_path: str, n_expect: int,
                       device=None) -> np.ndarray:
    """Corpus embeddings from a trained NeuralPathSim checkpoint (written
    by either package), validated against the served corpus size; the
    tower runs on ``device`` (None: CUDA)."""
    from ..models.neural import NeuralPathSim

    model = NeuralPathSim.load(model_path, device=device)
    if model.n != n_expect:
        raise ValueError(
            f"checkpoint {model_path!r} embeds {model.n} nodes; the "
            f"served graph has {n_expect} — retrain/rebuild against "
            "the served dataset"
        )
    return np.asarray(model.embeddings(), dtype=np.float32)


def default_centroids(n: int, mult: float = 1.0) -> int:
    """The √N heuristic floor the ``ann_centroids`` knob scales."""
    return max(1, int(round(mult * np.sqrt(max(n, 1)))))


def build_index(
    hin=None,
    metapath=None,
    variant: str = "rowsum",
    c: np.ndarray | None = None,
    d: np.ndarray | None = None,
    embedding: str = "struct",
    model_path: str | None = None,
    n_centroids: int | None = None,
    cluster_cap: int | None = None,
    token: tuple[str, int] = ("", 0),
    seed: int = 0,
    max_dim: int = 1024,
    device=None,
) -> CentroidIndex:
    """The one build entry point (CLI, serving startup, tests). Pass
    either a graph (``hin`` + ``metapath``) or precomputed ``c``/``d``
    (the serving layer already holds both). ``device`` is where the
    built index will probe (None: CUDA); the build is host work but
    for a learned embedding, whose tower runs there."""
    from .. import tuning

    if c is None or d is None:
        if hin is None or metapath is None:
            raise ValueError("build_index needs hin+metapath or c+d")
        c, d = half_chain_and_denominators(hin, metapath, variant)
    n = c.shape[0]
    quad = None
    if embedding == "struct":
        quad = cauchy_quadrature(d, m=_QUAD_M)
        emb = struct_embeddings(c, d, quad=quad, max_dim=max_dim, seed=seed)
    elif embedding == "learned":
        if model_path is None:
            raise ValueError("embedding='learned' needs model_path")
        emb = learned_embeddings(model_path, n, device=device)
    else:
        raise ValueError(
            f"unknown embedding source {embedding!r}; "
            "choose 'struct' or 'learned'"
        )
    if n_centroids is None:
        # 2·√N default (measured): finer clusters → smaller caps →
        # less probe/rerank pad traffic at equal routing recall
        mult = tuning.choose("ann_centroids", n=n, default=2.0)
        n_centroids = default_centroids(n, float(mult))
    if cluster_cap is None:
        cluster_cap = tuning.choose("ann_cluster_cap", n=n, default=None)
    index = CentroidIndex.build(
        emb,
        n_centroids=n_centroids,
        cluster_cap=int(cluster_cap) if cluster_cap else None,
        token=token,
        seed=seed,
        meta={
            "embedding": embedding,
            "variant": variant,
            "metapath": getattr(metapath, "name", None),
            "dim": int(emb.shape[1]),
            "model_path": model_path,
            # the refresh contract: re-embeds must reuse this grid and
            # projection, or inner products across rows go inconsistent
            "quad_t": list(quad[0]) if quad is not None else None,
            "quad_w": list(quad[1]) if quad is not None else None,
            "max_dim": int(max_dim),
            "seed": int(seed),
        },
        device=device,
    )
    if "cap_raised_from" in index.meta:
        runtime_event(
            "index_cap_raised", echo=False,
            requested=index.meta["cap_raised_from"],
            actual=index.cluster_cap,
        )
    runtime_event(
        "index_built", echo=False, n=index.n,
        centroids=index.n_centroids, cap=index.cluster_cap,
        dim=index.dim, embedding=embedding,
    )
    return index


def refresh_embeddings(
    index: CentroidIndex,
    rows: np.ndarray,
    c: np.ndarray,
    d: np.ndarray,
) -> np.ndarray:
    """Fresh embeddings for ``rows`` from the PATCHED graph state,
    consistent with the build's map (the persisted quadrature grid and
    projection seed — NOT a recomputed grid, which would break
    inner-product consistency with un-refreshed rows). Only meaningful
    for the struct map — a learned index refreshes by re-running the
    tower offline, which the serving layer surfaces as 'rebuild
    required' instead."""
    if index.meta.get("embedding") != "struct":
        raise ValueError(
            "in-place refresh is only supported for struct-embedded "
            "indexes; rebuild the learned index offline"
        )
    quad = (
        np.asarray(index.meta["quad_t"]), np.asarray(index.meta["quad_w"])
    )
    rows = np.asarray(rows, dtype=np.int64)
    from ..obs.trace import get_tracer

    # φ is row-local given the pinned grid, so only the affected rows'
    # C/d slices are embedded — the refresh stays O(Δ), not O(N). The
    # span parents into the refresh trace (the background ann.refresh
    # root, or a protocol refresh_index's serve.op).
    with get_tracer().child_span(
        "index.refresh_embed", rows=int(rows.shape[0])
    ):
        return struct_embeddings(
            np.asarray(c)[rows], np.asarray(d)[rows], quad=quad,
            max_dim=int(index.meta.get("max_dim", 1024)),
            seed=int(index.meta.get("seed", 0)),
        )
