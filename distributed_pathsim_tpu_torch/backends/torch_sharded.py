"""Multi-device sharded backend (BASELINE.json config 3): ``torch-sharded``.

The port of the JAX package's ``jax-sharded``. The symmetric half chain
runs through parallel/sharded.py on a 1-D ``dp`` mesh: the half-chain
factor C (host-folded from COO, [N, V]) is row-sharded so each shard owns
the rows of M it computes; the only collectives are one ``psum`` (column
totals for the row sums) and either one ``all_gather`` or the ring for
the all-pairs product and the distributed top-k. The same program runs
on D virtual shards of the host (the tests), D shards of one card, one
shard per card, and across processes (parallel/multihost.py).

On the card every ring step's score-and-extract is K3
(``fused_topk_twopass_rect``) wherever K3 takes the shape; the torch fold
runs only where K3 rejects it (k >= 16). f32 counts are exact below 2²⁴,
guarded from the host COO before anything is placed or cached.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..ops import chain
from ..ops import cuda_kernels as ck
from ..ops import planner
from ..parallel import multihost
from ..parallel.mesh import gather_rows, make_mesh
from ..parallel.sharded import (
    choose_allpairs_strategy,
    resolve_ring_kernel,
    shard_limbs,
    sharded_chain_outputs,
    sharded_topk,
    sharded_topk_stepwise,
)
from ..utils.device import resolve_device
from .base import PathSimBackend, register_backend


def _rowsums_of(coo) -> np.ndarray:
    """Row sums of M = C Cᵀ straight from the COO, exact in f64: rowsum_i
    = Σ_e w_e · colsum[col_e] over row i's entries (no dense C)."""
    w = np.asarray(coo.weights, dtype=np.float64)
    colsum = np.bincount(coo.cols, weights=w, minlength=coo.shape[1])
    return np.bincount(coo.rows, weights=w * colsum[coo.cols],
                       minlength=coo.shape[0])


@register_backend("torch-sharded")
class TorchShardedBackend(PathSimBackend):
    """Row-sharded chain over ``n_devices`` shards of ``device``'s type."""

    def __init__(self, hin, metapath, n_devices: int | None = None,
                 allpairs_strategy: str = "auto", dtype=torch.float32,
                 device=None, exact_counts: bool = True, **options):
        self.device = resolve_device(device)
        super().__init__(hin, metapath, **options)
        self.options = {**options, "n_devices": n_devices,
                        "allpairs_strategy": allpairs_strategy,
                        "dtype": dtype, "device": self.device,
                        "exact_counts": exact_counts}
        if not metapath.is_symmetric:
            raise ValueError(
                "torch-sharded requires a symmetric metapath (M = C Cᵀ); "
                "use the dense backend for asymmetric chains"
            )
        if self.device.type == "cuda":
            ck.check_true_f32()
        if multihost.process_count() > 1:
            # host_row_range's contiguous ownership holds for the
            # processes-outermost construction; a shard count chosen per
            # process could break the local-data assembly
            if n_devices is not None:
                raise ValueError(
                    "n_devices is a single-process knob; a multi-process "
                    "run always uses every device in the job"
                )
            self.mesh = multihost.make_hybrid_mesh(
                tp=1, platform=self.device.type)
        else:
            self.mesh = make_mesh(n_devices, platform=self.device.type)
        self.n = hin.type_size(metapath.source_type)
        self.dtype = dtype
        self.exact_counts = exact_counts
        if allpairs_strategy == "auto":
            # C is [N, V], V the palindrome midpoint type's size
            v = hin.type_size(metapath.node_types[len(metapath.steps) // 2])
            allpairs_strategy = choose_allpairs_strategy(
                self.n, v, self.mesh.shape["dp"],
                torch.empty((), dtype=dtype).element_size())
        self.allpairs_strategy = allpairs_strategy
        # Sparse first: fold the half chain to COO on the host (O(nnz));
        # each process then densifies only its own rows of C
        # (parallel/multihost.distributed_first_block), so no process ever
        # holds all of C.
        self._install_coo(planner.fold_half(
            hin, metapath, memo=self._subchain_memo, plan=self.plan))

    # -- factor placement ------------------------------------------------

    def _check_exact(self, rowsums: np.ndarray) -> None:
        if self.exact_counts:
            chain.check_exact_counts(rowsums.max(initial=0.0), self.dtype)

    def _install_coo(self, coo) -> None:
        """Bind a (new) folded half-chain COO: the exact-count guard FIRST
        (nothing is placed or cached for a graph past it), then the host
        sort, the per-process dense assembly and the reset of every cache
        derived from C: M, the row sums and the shards' u8 limbs."""
        self._check_exact(_rowsums_of(coo))
        order = np.argsort(coo.rows, kind="stable")
        rows_s = coo.rows[order]
        cols_s = coo.cols[order]
        w_s = coo.weights[order]

        def load_rows(a: int, b: int) -> np.ndarray:
            lo, hi = np.searchsorted(rows_s, [a, b])
            out = np.zeros((b - a, coo.shape[1]), dtype=np.float64)
            np.add.at(out, (rows_s[lo:hi] - a, cols_s[lo:hi]), w_s[lo:hi])
            return out

        self._first = multihost.distributed_first_block(
            load_rows, coo.shape[0], coo.shape[1], self.mesh,
            dtype=self.dtype)
        self._coo_shape = coo.shape
        self._coo_nnz = int(coo.rows.shape[0])
        # kept for the checkpoint fingerprint, hashed lazily
        self._coo_sorted = (rows_s, cols_s, w_s)
        self._coo_digest_cache = None
        self._m = None
        self._rowsums = None
        self._limbs = None

    def check_delta(self, plan) -> None:
        """The exact-count guard on the graph ``plan`` would produce, from
        its patched host factor, before :meth:`apply_delta` touches
        anything."""
        if plan.half_new is not None:
            self._check_exact(_rowsums_of(plan.half_new))

    def _apply_delta_impl(self, plan) -> None:
        """Re-install the plan's patched factor (no chain refold): the
        guard, one host re-sort and the per-process row assembly. The
        factor's capacity shape never changes under a non-fallback delta.
        M, the row sums and the limbs go with the old C."""
        self._install_coo(plan.half_new)
        self.hin = plan.hin_new
        self.n = self.hin.type_size(self.metapath.source_type)

    @property
    def _coo_digest(self) -> str:
        if self._coo_digest_cache is None:
            rows_s, cols_s, w_s = self._coo_sorted
            h = hashlib.sha256()
            h.update(np.ascontiguousarray(rows_s, dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(cols_s, dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(w_s, dtype=np.float64).tobytes())
            self._coo_digest_cache = h.hexdigest()[:16]
        return self._coo_digest_cache

    # -- primitives -------------------------------------------------------

    def _compute(self, want_m: bool):
        if self._rowsums is None or (want_m and self._m is None):
            m, rowsums = sharded_chain_outputs(
                self._first, (), mesh=self.mesh,
                allpairs_strategy=self.allpairs_strategy, want_m=want_m)
            host = gather_rows(rowsums, self.mesh).astype(np.float64)
            if want_m:
                self._m = gather_rows(m, self.mesh).astype(
                    np.float64)[: self.n, : self.n]
            self._rowsums = host[: self.n]

    def global_walks(self) -> np.ndarray:
        self._compute(want_m=False)
        return self._rowsums

    def commuting_matrix(self) -> np.ndarray:
        self._compute(want_m=True)
        return self._m

    def pairwise_row(self, source_index: int) -> np.ndarray:
        return self.commuting_matrix()[source_index]

    def pairwise_rows(self, rows) -> np.ndarray:
        """Batched M[rows, :]: one gather from the (sharded-computed,
        host-resident) commuting matrix."""
        return self.commuting_matrix()[np.asarray(rows, dtype=np.int64)]

    def _shard_limbs(self, use_kernel: bool):
        """The shards' u8 limbs, split once per graph at the first K3 ring
        (None on the host and on the fold)."""
        if not use_kernel or self.device.type != "cuda":
            return None
        if self._limbs is None:
            self._limbs = shard_limbs(self._first, True)
        return self._limbs

    def _use_ring_kernel(self, k: int) -> bool:
        return resolve_ring_kernel(self.n, self._coo_shape[1], k,
                                   self.device)

    def _host_topk(self, vals, idxs):
        return (gather_rows(vals, self.mesh).astype(np.float64)[: self.n],
                gather_rows(idxs, self.mesh).astype(np.int64)[: self.n])

    def topk(self, k: int = 10, mask_self: bool = True,
             variant: str = "rowsum"):
        """Distributed per-row top-k over the ring: no shard holds more
        than an [n_loc, n_loc] score tile, and only the [N, k] winners come
        to the host. The ring step (K3 or the fold) is resolved per call,
        so a tuning table installed later still counts."""
        use_kernel = self._use_ring_kernel(k)
        vals, idxs = sharded_topk(
            self._first, (), mesh=self.mesh, k=k, n_true=self.n,
            mask_self=mask_self, variant=variant, use_kernel=use_kernel,
            limbs=self._shard_limbs(use_kernel))
        return self._host_topk(vals, idxs)

    def _ring_run_config(self, k: int, variant: str, use_kernel: bool) -> dict:
        """Checkpoint identity of the stepwise ring: graph fingerprint +
        shard count (row-block boundaries) + k + variant + dtype + compute
        path. A directory from another mesh, graph or path fails loudly."""
        return {
            "n": int(self.n),
            "v": int(self._coo_shape[1]),
            "nnz": self._coo_nnz,
            "digest": self._coo_digest,
            "n_devices": int(self.mesh.shape["dp"]),
            "k": int(k),
            "metapath": self.metapath.name,
            "variant": variant,
            "dtype": str(self.dtype),
            "compute_path": "ring-k3" if use_kernel else "ring-fold",
            "format": "ring-topk-v1",
        }

    def topk_scores(self, k: int = 10, variant: str = "rowsum",
                    checkpoint_dir: str | None = None,
                    use_kernel: bool | None = None,
                    checkpoint_every_steps: int = 1):
        """Ring top-k with mid-ring checkpoint and resume: one ring step
        per call, the [N, k] running bests checkpointed every
        ``checkpoint_every_steps`` steps; the same arrays as :meth:`topk`
        at any kill point. ``driver.rank_all`` routes its
        ``checkpoint_dir`` here. ``use_kernel``: force K3 (its plain
        version on the host) or the fold."""
        if checkpoint_dir is None and use_kernel is None:
            # no resume asked for: the fused ring (no per-step host
            # round trips)
            return self.topk(k=k, variant=variant)
        if use_kernel is None:
            use_kernel = self._use_ring_kernel(k)
        ckpt = None
        if checkpoint_dir is not None:
            from ..utils.checkpoint import CheckpointManager

            ckpt = CheckpointManager(
                checkpoint_dir,
                config=self._ring_run_config(k, variant, use_kernel))
        vals, idxs = sharded_topk_stepwise(
            self._first, (), mesh=self.mesh, k=k, n_true=self.n,
            variant=variant, use_kernel=use_kernel, ckpt=ckpt,
            every=checkpoint_every_steps,
            limbs=self._shard_limbs(use_kernel))
        return self._host_topk(vals, idxs)
