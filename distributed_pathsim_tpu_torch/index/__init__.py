"""Sublinear top-k candidate generation: a centroid MIPS index.

Exact PathSim serving scores a full O(N) row per query; at millions of
authors a production service can't. This package puts a *candidate
generation* tier in front of the exact engine: a k-means
centroid-quantized inner-product index over the analytic node
embeddings, with the per-cluster embeddings packed into padded
shape-stable blocks so a probe is ONE batched matmul on the card — no
gather-heavy IVF traversal — and the exact f64 scorer reranks the
candidates, so the user-visible answer stays exact whenever the true
top-k is inside the candidate set (tie order included).

- :mod:`mips` — :class:`CentroidIndex`: build (k-means + capacity-
  bounded packing, host numpy), probe (batched torch ops on the
  index's device, static shapes), per-row staleness + in-place
  refresh, atomic save/load (the JAX package's artifact format);
  :func:`~.mips.balanced_kmeans` also groups the batch tier's
  ``simjoin --grouping centroid`` rows.
- :mod:`build` — the analytic embedding map and the graph → index
  build pipeline.
- :mod:`cli` — ``dpathsim-torch index build`` / ``dpathsim-torch index
  probe``.

The serving integration (``--topk-mode ann``, exact fallback, shadow-
recall confidence, delta staleness) lives in serving/service.py and
serving/ann.py.
"""

from .build import build_index, struct_embeddings  # noqa: F401
from .mips import CentroidIndex, IndexMismatch  # noqa: F401

__all__ = [
    "CentroidIndex",
    "IndexMismatch",
    "build_index",
    "struct_embeddings",
]
