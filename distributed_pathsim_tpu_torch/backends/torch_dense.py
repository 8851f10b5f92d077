"""Single-device dense backend on torch: the main path's compute.

The port of the JAX package's ``jax`` backend. The half-chain factor C
is folded on the host as COO (ops/planner.py), shipped to the device as
O(nnz) index arrays and scatter-built there; row sums, the diagonal and
pairwise rows are GEMVs/GEMMs against it; rank-all and all-pairs run on
the hand-written CUDA kernels (ops/cuda_kernels.py), or on their plain
torch versions when the device is the CPU. Rank-all picks its kernel as
the JAX package does: K1 while its candidate buffer fits, then K3 over
row tiles, then the single-pass K4 (k > 16, no self mask, or f64). The
kernels multiply C's u8 limbs, split once per graph and handed to every
launch. Asymmetric chains run as a plan-ordered ``torch.matmul`` chain.

f32 throughout, exact for integer path counts below 2²⁴ (asserted, not
assumed: the row sums are checked against the guard). On the card every
torch matmul runs in true f32: the backend refuses to start while TF32
is on (:func:`cuda_kernels.check_true_f32`; the entry points turn it off
with :func:`cuda_kernels.true_f32`).
float64 is real float64 here, on the host and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import chain
from ..ops import cuda_kernels as ck
from ..ops import planner
from ..utils.device import resolve_device
from .base import PathSimBackend, register_backend


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


@register_backend("torch")
class TorchDenseBackend(PathSimBackend):
    """Dense chain on one device: CUDA unless ``device`` says the CPU."""

    def __init__(self, hin, metapath, dtype=torch.float32, device=None,
                 exact_counts: bool = True, **options):
        """``exact_counts=False`` waives the f32 2^24 exact-integer guard
        (the CLI's ``--approx``) for graphs whose path counts exceed it:
        scores are scale-invariant ratios in C, so f32 costs only ~1e-6
        relative rounding, and rankings may swap near-exact ties."""
        self.device = resolve_device(device)
        super().__init__(hin, metapath, **options)
        self.dtype = dtype
        self.exact_counts = exact_counts
        if self.device.type == "cuda":
            ck.check_true_f32()
        self._symmetric = metapath.is_symmetric
        if self._symmetric:
            # Only the folded COO crosses host→device (O(nnz), not
            # O(N·P) dense blocks); C is scatter-built on the device.
            coo = planner.fold_half(hin, metapath, plan=self.plan)
            self._c_shape = coo.shape
            self._coo = (
                torch.as_tensor(coo.rows, dtype=torch.int64,
                                device=self.device),
                torch.as_tensor(coo.cols, dtype=torch.int64,
                                device=self.device),
                torch.as_tensor(coo.weights, dtype=dtype, device=self.device),
            )
            self._blocks = None
        else:
            host_blocks = chain.oriented_dense_blocks(
                hin, metapath.steps, dtype=np.float32
            )
            self._blocks = [
                torch.as_tensor(b, device=self.device).to(dtype)
                for b in host_blocks
            ]
        self._m = None
        self._rowsums = None
        self._half_cache = None
        self._limbs_cache = None

    def _half(self):
        """(C, rowsums) on the device for a symmetric chain, built once:
        the factor is a per-graph constant."""
        if self._half_cache is None:
            rows, cols, weights = self._coo
            c = torch.zeros(self._c_shape, dtype=self.dtype,
                            device=self.device)
            # duplicate coordinates (a raw single-step half) accumulate;
            # integer adds are exact in any order
            c.index_put_((rows, cols), weights, accumulate=True)
            self._half_cache = (c, chain.rowsums_from_half(c))
            self._limbs_cache = None
        return self._half_cache

    def _limbs(self, c):
        """C's u8 limbs as the kernels read them (None on the CPU), split
        once per graph beside C (:func:`cuda_kernels.kernel_limbs`) at the
        first kernel call that needs them, so no rank-all or all-pairs
        call pays the split."""
        if self._limbs_cache is None:  # stays None on the CPU, at no cost
            self._limbs_cache = ck.kernel_limbs(c)
        return self._limbs_cache

    def _check_exact(self, rowsums: np.ndarray) -> None:
        if self.exact_counts:
            chain.check_exact_counts(rowsums.max(initial=0.0), self.dtype)

    def _fetch_rowsums(self, rowsums: torch.Tensor) -> None:
        """Host copy of the row sums + the exact-count guard, once per
        backend (the row sums are as immutable as the graph)."""
        if self._rowsums is None:
            self._rowsums = _host(rowsums)
            self._check_exact(self._rowsums)

    def _compute(self):
        if self._m is None:
            if self._symmetric:
                c, rowsums = self._half()
                m = chain.commuting_matrix_from_half(c)
            else:
                m = planner.execute_dense(self.plan, self._blocks)
                rowsums = m.sum(1)
            self._m = _host(m)
            self._rowsums = _host(rowsums)
            self._check_exact(self._rowsums)
        return self._m, self._rowsums

    def commuting_matrix(self) -> np.ndarray:
        return self._compute()[0][: self.n_sources, : self.n_targets]

    def global_walks(self) -> np.ndarray:
        if self._rowsums is None:
            if self._symmetric:
                self._fetch_rowsums(self._half()[1])
            else:
                self._fetch_rowsums(planner.rowsums_fold(self._blocks))
        return self._rowsums[: self.n_sources]

    def diagonal(self) -> np.ndarray:
        if not self._symmetric:
            return super().diagonal()
        c, rowsums = self._half()
        self._fetch_rowsums(rowsums)
        return _host(self._diag(c))[: self.n_sources]

    @staticmethod
    def _diag(c: torch.Tensor) -> torch.Tensor:
        """diag(M)[i] = Σ_v C[i,v]² — the textbook-PathSim denominator,
        without materializing M."""
        return (c * c).sum(1)

    def pairwise_row(self, source_index: int) -> np.ndarray:
        if self._symmetric:
            # One GEMV against the half factor: materializing M here
            # would be O(N²) memory.
            c, rowsums = self._half()
            row = chain.pairwise_row_from_half(c, source_index)
            self._fetch_rowsums(rowsums)
            return _host(row)[: self.n_targets]
        return self._compute()[0][source_index, : self.n_targets]

    def pairwise_rows(self, rows) -> np.ndarray:
        """Batched M[rows, :] as one GEMM against the half factor."""
        if not self._symmetric:
            return super().pairwise_rows(rows)
        c, rowsums = self._half()
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64),
                              device=self.device)
        out = c[idx] @ c.T
        self._fetch_rowsums(rowsums)
        return _host(out)[:, : self.n_targets]

    # -- on-device scoring ---------------------------------------------------

    def _denominator_device(self, c, rowsums, variant: str):
        """"rowsum" passes the global-walk row sums (reference
        semantics), "diagonal" diag(M) (textbook PathSim). diag(M) ≤
        rowsums(M) elementwise, so the f32 guard on the row sums covers
        both."""
        if variant == "rowsum":
            return rowsums
        if variant == "diagonal":
            return self._diag(c)
        raise ValueError(f"unknown PathSim variant {variant!r}")

    def all_pairs_scores(self, variant: str = "rowsum") -> np.ndarray:
        """The score matrix (f32 on the host), from K2 on the card."""
        if not self._symmetric:
            return super().all_pairs_scores(variant)
        c, rowsums = self._half()
        d = self._denominator_device(c, rowsums, variant)
        self._fetch_rowsums(rowsums)
        scores = ck.fused_scores(c, d, limbs=self._limbs(c))
        n = self.n_sources
        return scores[:n, :n].cpu().numpy()

    def topk(self, k: int = 10, mask_self: bool = True,
             variant: str = "rowsum"):
        """Per-source top-k (values f32, indices int64), ordered
        (descending score, ascending column), fully on the device. The
        JAX package's dispatch: K1 + pass 2 while k <= 16 and its
        candidate buffer fits; past the buffer, with the self mask and
        f32, row tiles through K3 (:meth:`_topk_rect_stream`); otherwise
        the single-pass K4. Both score variants ride the same kernels:
        only the denominator vector differs."""
        if not self._symmetric:
            raise ValueError("topk fast path requires a symmetric metapath")
        c, rowsums = self._half()
        d = self._denominator_device(c, rowsums, variant)
        limbs = self._limbs(c)
        n_rows = c.shape[0]
        if k <= ck.CAND_MAX and ck.twopass_fits(n_rows, k, self.device):
            vals, idxs = ck.fused_topk_twopass(c, d, k=k, mask_self=mask_self,
                                               limbs=limbs)
        elif (
            mask_self  # K3 always excludes the self pair
            and self.dtype == torch.float32
            and ck.rect_supported(c.shape[1], k)
        ):
            vals, idxs = self._topk_rect_stream(c, d, k, limbs)
        else:
            vals, idxs = ck.fused_topk(c, d, k=k, mask_self=mask_self,
                                       limbs=limbs)
        self._fetch_rowsums(rowsums)
        n = self.n_sources
        return vals[:n].cpu().numpy(), idxs[:n].cpu().numpy()

    # Row-tile height of the rect arm (halved until K3's candidate
    # buffer fits its budget).
    _RECT_TILE_ROWS = 8192

    def _topk_rect_stream(self, c, d, k: int, limbs):
        """Per-source top-k past K1's candidate budget: each row tile
        against the whole column range through K3 + pass 2, on C's
        cached ``limbs`` (rect_pad_factor pads nothing, so they fit the
        contiguous f32 factor it hands K3). Results stay on the device
        ([N, k] is small); the caller fetches once."""
        n = c.shape[0]
        tile_rows = self._RECT_TILE_ROWS
        while tile_rows > 256 and not ck.rect_fits(n, tile_rows, k,
                                                   self.device):
            tile_rows //= 2
        cc, dc, limbs = ck.rect_pad_factor(c, d, limbs)
        ids = torch.arange(n, dtype=torch.int32, device=c.device)
        outs = [
            ck.fused_topk_twopass_rect(
                cc[i0:i0 + tile_rows], cc, dc[i0:i0 + tile_rows], dc,
                ids[i0:i0 + tile_rows], k=k, n_true_cols=n,
                limbs=None if limbs is None else (
                    limbs.rows(i0, i0 + tile_rows), limbs),
            )
            for i0 in range(0, n, tile_rows)
        ]
        return (torch.cat([v for v, _ in outs]),
                torch.cat([i for _, i in outs]))
