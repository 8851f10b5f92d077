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
float64 is real float64 for the row sums, single-source rows and
batched rows, on the host and on the card. All-pairs on the card runs
the f32 kernel: a float64 factor is cast at its entry, behind the 2²⁴
guard (:func:`cuda_kernels.kernel_operands`; ``--approx`` waives it); on
the CPU its plain version computes in float64.

Exact counts past 2²⁴ (``exact_counts``, the default, on a symmetric
chain): the row sums are computed in f64 on the device, exact below
2⁵³, and rank-all ranks by the upstream's score, ``2·M / (d_i + d_j)``
of the exact counts correctly rounded in f64, ties to the lower column:
the exact instances of K1 + pass 2 and K4 on the card, their plain
versions in float64 on the CPU. The guard stays on the paths that carry
counts in f32 (single-source and batched rows, M, the diagonal,
all-pairs).
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.trace import get_tracer
from ..ops import chain
from ..ops import cuda_kernels as ck
from ..ops import planner
from ..utils.device import resolve_device
from .base import PathSimBackend, register_backend


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _pad_coo_bucket(rows, cols, weights):
    """Pad a COO triple to a power-of-two nnz bucket (floor 8), so
    steady-state delta patches allocate the same shapes whatever their
    size within a bucket. Pad entries carry weight 0 at (0, 0) and
    scatter harmlessly."""
    nnz = int(rows.shape[0])
    bucket = max(8, 1 << (max(nnz, 1) - 1).bit_length())
    r = np.zeros(bucket, dtype=np.int64)
    c = np.zeros(bucket, dtype=np.int64)
    w = np.zeros(bucket, dtype=np.float64)
    r[:nnz] = rows
    c[:nnz] = cols
    w[:nnz] = weights
    return r, c, w


class PendingRows:
    """The in-flight result of :meth:`TorchDenseBackend.pairwise_rows_device`:
    batched counts being computed on the backend's serving stream.

    ``np.asarray(handle)`` is where the host blocks (as on an un-fetched
    JAX device array): it makes a copy stream wait on the GEMM's event,
    copies the counts into a pinned host buffer there and waits for that
    copy alone — so on the card, the copy of one batch overlaps the next
    batch's GEMM instead of queueing behind it on one stream. On the CPU
    the counts are already computed and the handle only holds them."""

    def __init__(self, out: torch.Tensor, event=None, copy_stream=None):
        self._out = out
        self._event = event
        self._copy_stream = copy_stream

    def __array__(self, dtype=None, copy=None):
        out = self._out
        if self._event is None:
            host = out.numpy()
        else:
            with torch.cuda.stream(self._copy_stream):
                self._copy_stream.wait_event(self._event)
                pinned = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
                pinned.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            done.synchronize()
            host = pinned.numpy()
        return host if dtype is None else host.astype(dtype, copy=False)


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
        self.options = {**options, "dtype": dtype, "device": self.device,
                        "exact_counts": exact_counts}
        self.dtype = dtype
        self.exact_counts = exact_counts
        if self.device.type == "cuda":
            ck.check_true_f32()
        self._symmetric = metapath.is_symmetric
        if self._symmetric:
            # Only the folded COO crosses host→device (O(nnz), not
            # O(N·P) dense blocks); C is scatter-built on the device.
            coo = planner.fold_half(hin, metapath, memo=self._subchain_memo,
                                    plan=self.plan)
            self._c_shape = coo.shape
            with get_tracer().span("backend.factor",
                                   device=self.device) as span:
                self._coo = (
                    torch.as_tensor(coo.rows, dtype=torch.int64,
                                    device=self.device),
                    torch.as_tensor(coo.cols, dtype=torch.int64,
                                    device=self.device),
                    torch.as_tensor(coo.weights, dtype=dtype,
                                    device=self.device),
                )
                if span is not None:
                    span.args["bytes"] = sum(t.nbytes for t in self._coo)
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
        self._rowsums64 = None
        # serving streams (card only, made at the first batched issue):
        # the GEMMs of pairwise_rows_device and the host copies of their
        # results, each on its own stream
        self._serve_streams = None

    def _half(self):
        """(C, rowsums) on the device for a symmetric chain, built once:
        the factor is a per-graph constant."""
        if self._half_cache is None:
            rows, cols, weights = self._coo
            with get_tracer().span("backend.factor",
                                   device=self.device) as span:
                c = torch.zeros(self._c_shape, dtype=self.dtype,
                                device=self.device)
                # duplicate coordinates (a raw single-step half)
                # accumulate; integer adds are exact in any order
                c.index_put_((rows, cols), weights, accumulate=True)
                self._half_cache = (c, chain.rowsums_from_half(c))
                if span is not None:
                    span.args["bytes"] = sum(t.nbytes
                                             for t in self._half_cache)
            self._limbs_cache = None
            self._rowsums64 = None
        return self._half_cache

    def _rowsums_exact(self) -> torch.Tensor:
        """The row sums of a symmetric chain exact in f64 on the device
        (C's integer counts summed in f64: exact below 2⁵³), made once
        per factor."""
        if self._rowsums64 is None:
            c = self._half()[0]
            with get_tracer().span("backend.factor",
                                   device=self.device) as span:
                self._rowsums64 = chain.rowsums_from_half(c.double())
                if span is not None:
                    span.args["bytes"] = self._rowsums64.nbytes
        return self._rowsums64

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

    def _fetch_rowsums(self, rowsums: torch.Tensor,
                       guard: bool = True) -> None:
        """Host copy of the row sums, once per backend (the row sums are
        as immutable as the graph): ``rowsums``, and under exact counts
        on a symmetric chain past 2²⁴, where f32 sums round, the exact
        f64 ones (:meth:`_rowsums_exact`; f32 sums of nonnegative
        integers reach 2²⁴ exactly when the exact ones do). With
        ``guard`` (the paths that carry counts in f32) the exact-count
        guard runs on every call, BEFORE a first copy is cached, so a
        graph past it raises on every call, never only the first."""
        host = self._rowsums
        if host is None:
            host = _host(rowsums)
            if (self.exact_counts and self._symmetric
                    and host.max(initial=0.0) >= chain.F32_EXACT_INT_MAX):
                host = _host(self._rowsums_exact())
        if guard:
            self._check_exact(host)
        self._rowsums = host

    def _exact_scores(self) -> bool:
        """Whether rank-all takes the exact instances: exact counts past
        f32's exact integers (2²⁴) on a symmetric chain. Below 2²⁴ the
        f32 kernels already count exactly. Raises OverflowError past
        2⁵², where d_i + d_j would leave f64's exact integers."""
        if not (self.exact_counts and self._symmetric):
            return False
        self._fetch_rowsums(self._half()[1], guard=False)
        top = float(self._rowsums.max(initial=0.0))
        if top >= 2.0**52:
            raise OverflowError(
                "path counts exceed 2^52: the sums of two row sums would "
                "leave f64's exact integers; pass --approx "
                "(exact_counts=False)")
        return top >= chain.F32_EXACT_INT_MAX

    def _compute(self):
        if self._m is None:
            if self._symmetric:
                c, rowsums = self._half()
                m = chain.commuting_matrix_from_half(c)
            else:
                m = planner.execute_dense(self.plan, self._blocks)
                rowsums = m.sum(1)
            host_rowsums = _host(rowsums)
            self._check_exact(host_rowsums)  # before anything is cached
            self._m = _host(m)
            self._rowsums = host_rowsums
        return self._m, self._rowsums

    def check_delta(self, plan) -> None:
        """The exact-count guard on the graph ``plan`` would produce,
        from its patched host factor C' (row sums of M' = C'·C'ᵀ as
        C'·(C'ᵀ·1), exact in f64) — so a service can refuse the update
        before :meth:`apply_delta` touches C."""
        half = plan.half_new
        if not self.exact_counts or half is None:
            return
        w = np.asarray(half.weights, dtype=np.float64)
        colsums = np.bincount(half.cols, weights=w,
                              minlength=half.shape[1])
        rowsums = np.bincount(half.rows, weights=w * colsums[half.cols],
                              minlength=half.shape[0])
        self._check_exact(rowsums)

    def commuting_matrix(self) -> np.ndarray:
        return self._compute()[0][: self.n_sources, : self.n_targets]

    def global_walks(self) -> np.ndarray:
        """The row sums on the host: under exact counts on a symmetric
        chain exact at any count below 2⁵³ (f64), so unguarded."""
        if self._symmetric:
            self._fetch_rowsums(self._half()[1], guard=False)
        elif self._rowsums is None:
            self._fetch_rowsums(planner.rowsums_fold(self._blocks))
        return self._rowsums[: self.n_sources]

    def _denominators(self, variant: str) -> np.ndarray:
        """The denominators of the single-source and serving paths,
        behind the exact-count guard on every call: their pairwise
        counts travel in f32."""
        if self._symmetric:
            self._fetch_rowsums(self._half()[1])
        return super()._denominators(variant)

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
        """Batched M[rows, :] — host view of :meth:`pairwise_rows_device`
        (the serving layer uses the handle directly to overlap the host
        copy of one batch with the next batch's GEMM)."""
        out = self.pairwise_rows_device(rows)
        if out is None:
            return super().pairwise_rows(rows)
        return np.asarray(out, dtype=np.float64)[:, : self.n_targets]

    def pairwise_rows_device(self, rows):
        """Batched row counts M[rows, :] = C[rows] @ Cᵀ as one gather +
        GEMM, returned as a :class:`PendingRows` handle, f32 counts at
        the padded width. On the card the work is queued on the
        backend's serving stream (after whatever the default stream
        queued on C) and the call returns before it finishes. Returns
        None for an asymmetric chain (counts come from the cached M)."""
        if not self._symmetric:
            return None
        c, rowsums = self._half()
        idx = np.asarray(rows, dtype=np.int64)
        # same exactness contract as pairwise_row: guard even when this
        # is the first call on the backend
        self._fetch_rowsums(rowsums)
        if self.device.type != "cuda":
            return PendingRows(c[torch.as_tensor(idx)] @ c.T)
        if self._serve_streams is None:
            self._serve_streams = (torch.cuda.Stream(self.device),
                                   torch.cuda.Stream(self.device))
        gemm_stream, copy_stream = self._serve_streams
        gemm_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(gemm_stream):
            ids = torch.as_tensor(idx).to(self.device, non_blocking=False)
            out = c[ids] @ c.T
            event = torch.cuda.Event()
            event.record(gemm_stream)
        return PendingRows(out, event, copy_stream)

    def _apply_delta_impl(self, plan) -> None:
        """Patch the device-resident half factor in place: one
        ``index_put_(accumulate=True)`` of the signed ΔC (padded to a
        power-of-two nnz bucket) and the row sums recomputed. f32 adds
        of small integers are exact below the 2^24 guard, so the
        patched factor equals a rebuilt one bit for bit. Every cache
        derived from C goes: M, the host row sums (the next fetch re-runs
        the exact-count guard) and C's u8 limbs — the kernels would
        otherwise rank the pre-delta counts."""
        from .base import DeltaUnsupported

        if not self._symmetric:
            raise DeltaUnsupported(
                "torch backend patches only the symmetric half factor"
            )
        dc = plan.delta_c
        rows, cols, w = _pad_coo_bucket(dc.rows, dc.cols, dc.weights)
        c, _ = self._half()
        if self._serve_streams is not None:
            # the scatter must not overtake a serving GEMM still reading C
            torch.cuda.current_stream(self.device).wait_stream(
                self._serve_streams[0])
        c.index_put_(
            (torch.as_tensor(rows, device=self.device),
             torch.as_tensor(cols, device=self.device)),
            torch.as_tensor(w, dtype=self.dtype, device=self.device),
            accumulate=True,
        )
        # _half_cache stays the single authority for (C, rowsums); the
        # construction-time COO is stale and never read again
        self._half_cache = (c, chain.rowsums_from_half(c))
        self._m = None
        self._rowsums = None
        self._limbs_cache = None
        self._rowsums64 = None

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

    def _denominator_exact(self, c, variant: str) -> torch.Tensor:
        """:meth:`_denominator_device` exact in f64 (the exact
        instances' d)."""
        if variant == "rowsum":
            return self._rowsums_exact()
        if variant == "diagonal":
            return self._diag(c.double())
        raise ValueError(f"unknown PathSim variant {variant!r}")

    def all_pairs_scores(self, variant: str = "rowsum") -> np.ndarray:
        """The score matrix on the host, from K2 on the card (f32) or its
        plain version on the CPU (the backend's dtype)."""
        if not self._symmetric:
            return super().all_pairs_scores(variant)
        c, rowsums = self._half()
        d = self._denominator_device(c, rowsums, variant)
        self._fetch_rowsums(rowsums)
        limbs = self._limbs(c)
        c, d = ck.kernel_operands(c, d, self.exact_counts)
        scores = ck.fused_scores(c, d, limbs=limbs)
        n = self.n_sources
        return scores[:n, :n].cpu().numpy()

    def topk(self, k: int = 10, mask_self: bool = True,
             variant: str = "rowsum"):
        """Per-source top-k (indices int64), ordered (descending score,
        ascending column), fully on the device. Values: f32 on the card
        and the backend's dtype on the CPU, the scores of exact counts
        below 2²⁴ (the JAX package's); under exact counts once the
        largest row sum reaches 2²⁴ float64 on both, the upstream's score
        of the exact counts (:meth:`_topk_exact`). The row sums decide
        at every call, so a delta across 2²⁴ switches the values' dtype
        and may reorder f32 near ties. The JAX package's
        dispatch: K1 + pass 2 while k <= 16 and its candidate buffer
        fits; past the buffer, with the self mask and f32, row tiles
        through K3 (:meth:`_topk_rect_stream`); otherwise the single-pass
        K4. Both score variants ride the same kernels: only the
        denominator vector differs."""
        if not self._symmetric:
            raise ValueError("topk fast path requires a symmetric metapath")
        c, rowsums = self._half()
        if self._exact_scores():
            vals, idxs = self._topk_exact(c, k, mask_self, variant)
        else:
            vals, idxs = self._topk_f32(c, rowsums, k, mask_self, variant)
        n = self.n_sources
        with get_tracer().span("backend.fetch", device=self.device,
                               pinned=False) as span:
            out = vals[:n].cpu().numpy(), idxs[:n].cpu().numpy()
            if span is not None:
                span.args["bytes"] = out[0].nbytes + out[1].nbytes
        return out

    def _topk_exact(self, c, k: int, mask_self: bool, variant: str):
        """Rank-all on the exact instances: K1 + pass 2 while k <= 16 and
        K1's 12-byte candidates fit, else K4; exact f64 denominators."""
        d = self._denominator_exact(c, variant)
        limbs = self._limbs(c)
        if k <= ck.CAND_MAX and ck.twopass_fits(c.shape[0], k, self.device,
                                                c.shape[1], exact=True):
            return ck.fused_topk_twopass_exact(c, d, k=k, mask_self=mask_self,
                                               limbs=limbs)
        return ck.fused_topk_exact(c, d, k=k, mask_self=mask_self,
                                   limbs=limbs)

    def _topk_f32(self, c, rowsums, k: int, mask_self: bool, variant: str):
        d = self._denominator_device(c, rowsums, variant)
        limbs = self._limbs(c)
        c, d = ck.kernel_operands(c, d, self.exact_counts)
        n_rows = c.shape[0]
        if k <= ck.CAND_MAX and ck.twopass_fits(n_rows, k, self.device,
                                                c.shape[1]):
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
        return vals, idxs

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
                                                   self.device, c.shape[1]):
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
