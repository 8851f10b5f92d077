"""Multi-metapath batched scoring (BASELINE.json config 4).

The reference hard-codes one metapath (APVPA) and would need a full
re-run of its 2N-1 joins per additional path. Here R symmetric metapaths
are compiled once, their half-chain factors C_r folded on the host and
densified on the device, and all R commuting matrices and score tensors
come out of torch matmuls in true f32 (no TF32: the scorer refuses to
start on the card with it on, as the dense backend does). A weighted
ensemble (Σ_r w_r · sim_r) gives the multi-path similarity used in
practice for HIN search.

The JAX package pads the factors to a common width and runs one batched
einsum outside any Pallas kernel; here each path keeps its own width —
zero padding adds exact zeros, so the integer counts, the row sums and
the f32 scores are the same bit for bit, and a narrow path never pays
for the widest one's columns. The weighted combination is a chain of
fused multiply-adds in path order, ``acc = fma(s_r, w_r, acc)`` with one
f32 rounding each (:func:`fma_f32`), which is what the JAX package's
``rnm,r->nm`` einsum computes on its CPU (tests/test_torch_multipath.py
holds the two bit for bit).

The all-sources top-k is the host ``argpartition`` arm (:meth:`topk`),
or row-sharded over a mesh (:meth:`topk_sharded`, ``--n-devices``).
Single-source answers (:meth:`topk_row`) stream from the sparse factors
in exact f64 on the host.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..data.encode import EncodedHIN
from ..ops import chain
from ..ops.metapath import MetaPath, compile_metapath
from ..utils.device import resolve_device


def fma_f32(acc: torch.Tensor, s: torch.Tensor, w: float) -> torch.Tensor:
    """``fl32(acc + s·w)`` with ONE rounding, as a fused multiply-add
    gives it, for f32 ``acc`` and ``s``: the product is exact in f64
    (24 + 24 bits), the sum is rounded to odd in f64 (round to nearest,
    then the neighbor with an odd last bit when the sum was inexact —
    its error term comes from TwoSum), and a round-to-odd f64 rounds to
    f32 correctly (53 ≥ 24 + 2 bits), so the double rounding cannot
    differ from the single one."""
    a = acc.double()
    p = s.double() * w
    hi = a + p
    bb = hi - a
    lo = (a - (hi - bb)) + (p - bb)  # TwoSum: hi + lo == a + p exactly
    even = (hi.view(torch.int64) & 1) == 0
    toward = torch.where(lo > 0, torch.full_like(hi, float("inf")),
                         torch.full_like(hi, float("-inf")))
    hi = torch.where((lo != 0) & even, torch.nextafter(hi, toward), hi)
    return hi.float()


def _sharded_combined_topk(factors, weights, mesh, k: int, n_true: int,
                           variant: str = "rowsum"):
    """Distributed weighted multi-path top-k: every path's factor [N_pad,
    V_r] is row-sharded over the mesh; each shard scores its row block of
    all R paths against the gathered factors, combines them with the
    ensemble weights (the fma chain of :func:`fma_f32`, in path order)
    and reduces to top-k locally. The only collectives are one ``psum``
    per path (column totals) and the ``all_gather`` of each factor.
    Returns host (values f32 [N_pad, k], columns int64 [N_pad, k])."""
    from ..ops.sparse import chunked_row_topk
    from ..parallel.mesh import all_gather, gather_rows, psum, split_rows

    locs = [split_rows(f, mesh) for f in factors]  # [R][shard] [n_loc, V_r]
    dens, fulls, dfulls = [], [], []
    for loc in locs:
        if variant == "rowsum":
            colsum = psum([c.sum(0) for c in loc], mesh)
            d = [c @ cs for c, cs in zip(loc, colsum)]
        elif variant == "diagonal":  # purely local, no collective
            d = [(c * c).sum(1) for c in loc]
        else:
            raise ValueError(f"unknown PathSim variant {variant!r}")
        dens.append(d)
        fulls.append(all_gather(loc, mesh))
        dfulls.append(all_gather(d, mesh))
    n_pad = factors[0].shape[0]
    # rows scored at a time: fma_f32's f64 temporaries stay near 1 GiB
    step = max(1, MultiMetapathScorer._COMBINE_ENTRIES // max(n_pad, 1))
    out_v, out_i = [], []
    for s in range(len(mesh.devices)):
        n_loc = locs[0][s].shape[0]
        dev = locs[0][s].device
        cols = torch.arange(n_pad, device=dev)
        parts_v, parts_i = [], []
        for r0 in range(0, n_loc, step):
            acc = None
            for r in range(len(factors)):
                m = locs[r][s][r0:r0 + step] @ fulls[r][s].T
                denom = (dens[r][s][r0:r0 + step, None]
                         + dfulls[r][s][None, :])
                sc = torch.where(denom > 0, (2.0 * m) / torch.where(
                    denom > 0, denom, 1.0), 0.0)
                acc = fma_f32(torch.zeros_like(sc) if acc is None else acc,
                              sc, weights[r])
            rows = ((mesh.first_shard + s) * n_loc + r0
                    + torch.arange(acc.shape[0], device=dev))
            drop = (cols >= n_true)[None, :] | (rows[:, None] == cols[None, :])
            v, i = chunked_row_topk(acc.masked_fill(drop, float("-inf")),
                                    cols.expand_as(acc), k)
            parts_v.append(v)
            parts_i.append(i)
        out_v.append(torch.cat(parts_v))
        out_i.append(torch.cat(parts_i))
    return gather_rows(out_v, mesh), gather_rows(out_i, mesh)


class MultiMetapathScorer:
    """Batched PathSim over several symmetric metapaths on one HIN.
    ``device``: the card by default, ``"cpu"`` for the host."""

    def __init__(
        self,
        hin: EncodedHIN,
        metapaths: Sequence[MetaPath | str],
        variant: str = "rowsum",
        device=None,
    ):
        from ..ops.pathsim import VARIANTS

        if variant not in VARIANTS:
            raise ValueError(
                f"unknown PathSim variant {variant!r}; choose {VARIANTS}"
            )
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from ..ops import cuda_kernels

            cuda_kernels.check_true_f32()
        self.variant = variant
        self.hin = hin
        self.metapaths: list[MetaPath] = [
            compile_metapath(m, hin.schema) if isinstance(m, str) else m
            for m in metapaths
        ]
        if not self.metapaths:
            raise ValueError("need at least one metapath")
        src_types = {m.source_type for m in self.metapaths}
        if len(src_types) != 1:
            raise ValueError(f"metapaths must share a source type, got {src_types}")
        for m in self.metapaths:
            if not m.is_symmetric:
                raise ValueError(f"metapath {m.name} is not symmetric")

        self.n = hin.type_size(self.metapaths[0].source_type)
        # Per-path half factors stay SPARSE at rest; the dense factors of
        # the all-pairs methods are built lazily, so the streaming
        # single-source path only ever touches the O(nnz) factors.
        from ..ops import planner

        self._coo = [
            planner.fold_half(hin, m).summed() for m in self.metapaths
        ]
        self._scores: torch.Tensor | None = None  # [R, N, N] on the device
        self._rowsums: np.ndarray | None = None

    @property
    def names(self) -> list[str]:
        return [m.name for m in self.metapaths]

    # Refuse to densify the factors beyond this many f32 entries in all
    # (≈ 8 GiB), as the JAX package refuses its padded stack. The
    # batched all-pairs methods need them; the streaming single-source
    # path never does.
    _DENSE_STACK_MAX_ENTRIES = 1 << 31

    def _factors(self) -> list[torch.Tensor]:
        """The dense [N, V_r] f32 factor of every path on the device."""
        entries = sum(self.n * c.shape[1] for c in self._coo)
        if entries > self._DENSE_STACK_MAX_ENTRIES:
            wide = self.names[int(np.argmax([c.shape[1] for c in self._coo]))]
            raise MemoryError(
                f"dense factors would hold {entries} f32 entries "
                f"({4 * entries / 2**30:.0f} GiB; widest path {wide}); the "
                "batched all-pairs methods can't run at this scale — use "
                "topk_row (streaming single-source, O(nnz)) instead"
            )
        out = []
        for c in self._coo:
            f = torch.zeros(c.shape, dtype=torch.float32, device=self.device)
            f[torch.as_tensor(c.rows, device=self.device),
              torch.as_tensor(c.cols, device=self.device)] = torch.as_tensor(
                c.weights, dtype=torch.float32, device=self.device)
            out.append(f)
        return out

    def _compute(self):
        """(scores [R, N, N] f32 on the device, denominators [R, N] f64
        on the host), computed once. The exact-count guard runs BEFORE
        anything is cached: a graph past it raises on every call, and
        the streaming state stays intact."""
        if self._scores is None:
            scores, dens = [], []
            for c in self._factors():
                m = c @ c.T
                if self.variant == "rowsum":
                    d = c @ c.sum(0)
                else:  # diagonal: Σ_v C[i,v]²
                    d = (c * c).sum(1)
                denom = d[:, None] + d[None, :]
                scores.append(torch.where(
                    denom > 0, (2.0 * m) / torch.where(denom > 0, denom, 1.0),
                    0.0))
                dens.append(d)
            d64 = torch.stack(dens).double().cpu().numpy()
            chain.check_exact_counts(d64.max(initial=0.0), torch.float32)
            self._scores = torch.stack(scores)
            self._rowsums = d64
        return self._scores, self._rowsums

    def _streaming_rowsums(self) -> np.ndarray:
        """[R, N] per-path denominators straight from the sparse
        factors — exact f64 integer bookkeeping (bincount sums), no
        dense factor, no [R, N, N]."""
        d_all = np.zeros((len(self._coo), self.n))
        for r, c in enumerate(self._coo):
            w = c.weights
            if self.variant == "rowsum":
                colsum = np.bincount(c.cols, weights=w, minlength=c.shape[1])
                d_all[r] = np.bincount(
                    c.rows, weights=w * colsum[c.cols], minlength=self.n
                )
            else:  # diagonal: Σ_v C[i,v]²
                d_all[r] = np.bincount(c.rows, weights=w * w,
                                       minlength=self.n)
        return d_all

    def _rows_scores_streaming(self, rows: np.ndarray) -> np.ndarray:
        """Batched streaming score rows [R, B, N] in O(B·Σ_r nnz_r):
        sim_r(row_b, j) = 2·(C_r[row_b]·C_r[j]) / (d_r[row_b] + d_r[j])
        with the numerators as one sparse gather-multiply-scatter per
        path. Exact f64 (integer counts sum exactly below 2⁵³)."""
        rows = np.asarray(rows, dtype=np.int64)
        d_all = self.global_walks()
        out = np.zeros((len(self._coo), rows.shape[0], self.n))
        for r, c in enumerate(self._coo):
            w = c.weights
            src = np.zeros((rows.shape[0], c.shape[1]))
            for b, row in enumerate(rows):
                mask = c.rows == row
                src[b, c.cols[mask]] = w[mask]  # coalesced: 1/col
            gathered = src[:, c.cols]  # [B, nnz]
            cc = np.stack([
                np.bincount(c.rows, weights=w * gathered[b], minlength=self.n)
                for b in range(rows.shape[0])
            ])
            denom = d_all[r, rows][:, None] + d_all[r][None, :]
            out[r] = np.where(denom > 0, 2.0 * cc / np.where(
                denom > 0, denom, 1.0), 0.0)
        return out

    def scores(self) -> np.ndarray:
        """[R, N, N] per-path score tensors (f32, on the host)."""
        return self._compute()[0].cpu().numpy()

    def global_walks(self) -> np.ndarray:
        """[R, N] per-path denominators (the reference's global walks
        under "rowsum"; diag(M_r) under "diagonal"). Streams from the
        sparse factors unless the dense all-pairs cache already paid
        for itself — the CLI header must not force an [R, N, N]."""
        if self._rowsums is None:
            self._rowsums = self._streaming_rowsums()
        return self._rowsums

    def _resolve_weights(self, weights: Sequence[float] | None) -> np.ndarray:
        """Uniform default / float32 cast / shape check — one place."""
        r = len(self.metapaths)
        w = (
            np.full(r, 1.0 / r, dtype=np.float32)
            if weights is None
            else np.asarray(weights, dtype=np.float32)
        )
        if w.shape != (r,):
            raise ValueError(f"need {r} weights, got shape {w.shape}")
        return w

    # Rows combined at a time: the f64 temporaries of fma_f32 stay near
    # 1 GiB whatever N.
    _COMBINE_ENTRIES = 1 << 26

    def _combined_device(self, weights) -> torch.Tensor:
        scores = self._compute()[0]
        w = [float(x) for x in self._resolve_weights(weights)]
        comb = torch.empty(scores.shape[1:], dtype=torch.float32,
                           device=scores.device)
        step = max(1, self._COMBINE_ENTRIES // max(self.n, 1))
        for i0 in range(0, self.n, step):
            acc = torch.zeros_like(comb[i0:i0 + step])
            for r in range(scores.shape[0]):
                acc = fma_f32(acc, scores[r, i0:i0 + step], w[r])
            comb[i0:i0 + step] = acc
        return comb

    def combined_scores(self, weights: Sequence[float] | None = None) -> np.ndarray:
        """Weighted multi-path similarity: Σ_r w_r · sim_r, [N, N] f32 on
        the host. Default weights are uniform (mean over paths)."""
        return self._combined_device(weights).cpu().numpy()

    def topk(self, k: int = 10, weights: Sequence[float] | None = None):
        """Top-k per source under the combined similarity, by a host
        argpartition (O(N² + N·k log k)) rather than a full row sort —
        the JAX package's host arm, identical to it row for row (ties at
        the k boundary break as argpartition breaks them). Blocks of rows
        run on a few threads (numpy releases the GIL in the partition);
        each row is selected on its own, so the blocking changes nothing
        in the result."""
        from concurrent.futures import ThreadPoolExecutor

        s = self.combined_scores(weights)
        np.fill_diagonal(s, -np.inf)
        k = min(k, s.shape[1] - 1)

        def block(i0: int):
            blk = s[i0:i0 + step]
            part = np.argpartition(-blk, k - 1, axis=1)[:, :k]
            part_vals = np.take_along_axis(blk, part, axis=1)
            order = np.argsort(-part_vals, axis=1, kind="stable")
            return (np.take_along_axis(part_vals, order, axis=1),
                    np.take_along_axis(part, order, axis=1))

        workers = min(8, os.cpu_count() or 1)
        step = max(256, -(-s.shape[0] // (4 * workers)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            blocks = list(pool.map(block, range(0, s.shape[0], step)))
        return (np.concatenate([v for v, _ in blocks]),
                np.concatenate([i for _, i in blocks]))

    def topk_sharded(
        self,
        k: int = 10,
        weights: Sequence[float] | None = None,
        n_devices: int | None = None,
    ):
        """Distributed :meth:`topk` over a ``dp`` mesh of ``n_devices``
        shards of the scorer's device (config-4 batching × config-3
        sharding): the same values, with ascending-column tie-breaks
        (:meth:`topk`'s argpartition breaks ties at the k boundary by its
        own order). The [R, N, N] score tensors never exist: each shard
        scores only its [n_loc, N] rows of every path
        (:func:`_sharded_combined_topk`). The exact-count guard runs on
        the host denominators first."""
        from ..parallel.mesh import make_mesh, pad_to_multiple

        chain.check_exact_counts(self.global_walks().max(initial=0.0),
                                 torch.float32)
        mesh = make_mesh(n_devices, platform=self.device.type)
        n_pad = pad_to_multiple(self.n, mesh.size)
        factors = [torch.nn.functional.pad(f, (0, 0, 0, n_pad - self.n))
                   for f in self._factors()]
        vals, idxs = _sharded_combined_topk(
            factors, [float(x) for x in self._resolve_weights(weights)],
            mesh, k=min(k, self.n - 1), n_true=self.n, variant=self.variant)
        return (vals.astype(np.float64)[: self.n],
                idxs.astype(np.int64)[: self.n])

    def topk_rows(
        self,
        rows,
        k: int = 10,
        weights: Sequence[float] | None = None,
    ):
        """Batched :meth:`topk_row`: (values f64 [B, k], indices int64
        [B, k]). ALWAYS the streaming exact-f64 O(B·nnz) path, so results
        never depend on whether an all-pairs method ran first. Tie order
        is (descending score, ascending column)."""
        from ..ops import pathsim

        w = self._resolve_weights(weights).astype(np.float64)
        rows = np.asarray(rows, dtype=np.int64)
        s = np.einsum("rbn,r->bn", self._rows_scores_streaming(rows), w)
        s[np.arange(rows.shape[0]), rows] = -np.inf
        return pathsim.topk_from_score_rows(
            s, min(k, max(s.shape[1] - 1, 1))
        )

    def topk_row(self, row: int, k: int = 10, weights: Sequence[float] | None = None):
        """Top-k for ONE source row — the B=1 case of :meth:`topk_rows`."""
        vals, idxs = self.topk_rows(
            np.asarray([row], dtype=np.int64), k=k, weights=weights
        )
        return vals[0], idxs[0]
