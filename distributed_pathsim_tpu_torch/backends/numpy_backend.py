"""NumPy f64 dense oracle.

The ground-truth backend: float64 keeps path counts exact far past f32's
2²⁴ integer range (SURVEY.md §7 "Path counts are integers"). Every other
backend is tested against this one; this one is tested against the
reference's own run-log arithmetic (SURVEY.md Appendix A golden vectors).
"""

from __future__ import annotations

import numpy as np

from ..ops import chain
from ..ops import planner
from .base import DeltaUnsupported, PathSimBackend, register_backend


@register_backend("numpy")
class NumpyBackend(PathSimBackend):
    def __init__(self, hin, metapath, dtype=np.float64, **options):
        super().__init__(hin, metapath, **options)
        self.options = {**options, "dtype": dtype}
        self.dtype = dtype
        if metapath.is_symmetric:
            # Plan-ordered sparse fold, densified once: identical
            # integers to the historical dense half_product (path
            # counts are exact in f64 under any association order),
            # without ever materializing the [N, P] intermediate.
            self._c = planner.dense_half(
                hin, metapath, dtype=dtype, memo=self._subchain_memo
            )
            self._blocks = None
        else:
            self._c = None
            self._blocks = chain.oriented_dense_blocks(hin, metapath.steps, dtype=dtype)
        self._m: np.ndarray | None = None
        self._rowsums: np.ndarray | None = None

    def commuting_matrix(self) -> np.ndarray:
        if self._m is None:
            if self._c is not None:
                self._m = chain.commuting_matrix_from_half(self._c)
            else:
                # DP-ordered association (the planner's whole point on
                # asymmetric chains): identical integers to the naive
                # left-to-right fold, measurably fewer FLOPs.
                self._m = planner.execute_dense(self.plan, self._blocks)
        return self._m[: self.n_sources, : self.n_targets]

    def global_walks(self) -> np.ndarray:
        if self._rowsums is None:
            if self._c is not None:
                self._rowsums = chain.rowsums_from_half(self._c)
            else:
                self._rowsums = planner.rowsums_fold(self._blocks)
        return self._rowsums[: self.n_sources]

    def pairwise_row(self, source_index: int) -> np.ndarray:
        n = self.n_targets
        if self._m is not None:
            return self._m[source_index, :n]
        if self._c is not None:
            return chain.pairwise_row_from_half(self._c, source_index)[:n]
        # general chain: fold source one-hot from the left
        v = self._blocks[0][source_index]
        for b in self._blocks[1:]:
            v = v @ b
        return v[:n]

    def pairwise_rows(self, rows) -> np.ndarray:
        """Batched M[rows, :] as ONE GEMM against the half factor (or a
        row-sliced chain fold). f64 path counts are exact integers below 2⁵³, so the GEMM's sum
        order cannot diverge from the per-row GEMV."""
        rows = np.asarray(rows, dtype=np.int64)
        n = self.n_targets
        if self._m is not None:
            return self._m[rows][:, :n]
        if self._c is not None:
            return (self._c[rows] @ self._c.T)[:, :n]
        v = self._blocks[0][rows]
        for b in self._blocks[1:]:
            v = v @ b
        return v[:, :n]

    def _apply_delta_impl(self, plan) -> None:
        """Patch the dense half factor with the signed ΔC scatter —
        f64 integer adds are exact, so the patched C equals a rebuilt C
        bit for bit — and drop the derived caches (M, rowsums), which
        recompute lazily from the patched factor through the very same
        code paths a fresh build uses."""
        if self._c is None:
            raise DeltaUnsupported(
                "numpy backend patches only the symmetric half factor"
            )
        dc = plan.delta_c
        np.add.at(self._c, (dc.rows, dc.cols), dc.weights.astype(self.dtype))
        self._m = None
        self._rowsums = None
