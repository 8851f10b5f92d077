"""Row-sharded commuting-matrix chain over a mesh (BASELINE.json config 3).

The first block of the chain (the source-type × next-type adjacency,
e.g. ``A_AP``) is sharded along its rows over the ``dp`` axis; the
remaining (small, contracted) blocks are replicated. Each shard computes
its row block of the half-chain ``C = A_AP @ A_PV`` locally; then

- global column total (Σ_x C[x, :]): local colsum + :func:`.mesh.psum`,
  the ONLY cross-shard reduction the row sums need;
- row sums: ``C_local @ colsum_total`` (no communication);
- all-pairs M row block: ``C_local @ C_fullᵀ`` with ``C_full`` from
  :func:`.mesh.all_gather` (moderate N), or from the ring of
  parallel/ring.py, which never holds all of M or all of C (large N).

Padding: the row axis is padded to a shard multiple with all-zero rows;
zero rows of ``A_AP`` give zero rows of C and M, add nothing to any
``psum``, and score −inf as columns (masked by ``n_true``).

Every GEMM runs in the factor's dtype; on the card the backends refuse
to start while TF32 is on, so f32 products of integer counts are exact
below 2²⁴.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from .mesh import (
    Mesh,
    all_gather,
    gather_rows,
    pad_to_multiple,
    per_device,
    ppermute,
    psum,
    split_rows,
)
from .ring import ring_allpairs_rowblock, ring_topk_rowblock, ring_topk_step

# all_gather places every peer's C block on every device: one copy per
# card, fast until the gathered [N_pad, V] factor crowds the card's
# memory; the ring keeps only two peer blocks live, at the cost of D − 1
# dependent steps. The JAX package budgets 2 GiB, an eighth of a v5e's
# 16 GB; the same eighth of an H100's 80 GB is 10 GiB, leaving the local
# M row block and the working set the rest of the card.
_ALLGATHER_C_MAX_BYTES = 10 << 30

RING_KERNEL_ARM = "rect-cuda"


def resolve_ring_kernel(n_rows: int, v_out: int, k: int,
                        device="cuda") -> bool:
    """Ring-step choice (the ``ring_kernel`` tuning knob): K3 wherever it
    takes the shape on the card (:func:`cuda_kernels.rect_supported`),
    the torch fold only where it rejects it (k >= 16) and on the host.
    Both are bit-identical, and the fold is a plain version, so on a
    K3-feasible shape no table can pick it: a tuned arm other than
    ``rect-cuda`` there (a JAX table's ``jnp-fold`` included) counts as a
    ``fallback`` lookup and K3 runs."""
    from .. import tuning

    feasible = (torch.device(device).type == "cuda"
                and ck.rect_supported(v_out, k))
    if not feasible:
        return False
    tuning.choose("ring_kernel", n=n_rows, v=v_out, default=RING_KERNEL_ARM,
                  valid=lambda arm: arm == RING_KERNEL_ARM)
    return True


def choose_allpairs_strategy(n_rows: int, v_width: int, n_devices: int,
                             itemsize: int = 4) -> str:
    """``allgather`` until the gathered C ([N_pad, V] on every device)
    passes :data:`_ALLGATHER_C_MAX_BYTES`; ``ring`` beyond. The fold,
    psum and top-k phases are the same under either."""
    n_pad = pad_to_multiple(n_rows, n_devices)
    gathered = n_pad * v_width * itemsize
    return "allgather" if gathered <= _ALLGATHER_C_MAX_BYTES else "ring"


def shard_first_block_rows(first, mesh: Mesh, axis: str = "dp",
                           dtype=None) -> list[torch.Tensor]:
    """Pad the row axis to a shard multiple and place the row shards
    (single process: every shard is local)."""
    n_dev = mesh.shape[axis]
    t = torch.as_tensor(np.asarray(first)) if not isinstance(
        first, torch.Tensor) else first
    n_pad = pad_to_multiple(t.shape[0], n_dev)
    if n_pad != t.shape[0]:
        t = torch.nn.functional.pad(t, (0, 0, 0, n_pad - t.shape[0]))
    return split_rows(t, mesh, dtype=dtype)


def replicate(x, mesh: Mesh, dtype=None) -> list[torch.Tensor]:
    t = torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    return per_device(t if dtype is None else t.to(dtype), mesh)


def _fold_local(first: list[torch.Tensor], rest: Sequence) -> list:
    """Each shard's rows of C: its first-block rows times the replicated
    rest of the half chain (``rest`` holds one list of per-shard copies
    per block)."""
    out = []
    for s, c in enumerate(first):
        for blk in rest:
            c = c @ blk[s]
        out.append(c)
    return out


def _denominators(c_local: list, mesh: Mesh, variant: str) -> list:
    if variant == "rowsum":
        colsum = psum([c.sum(0) for c in c_local], mesh)
        return [c @ cs for c, cs in zip(c_local, colsum)]
    if variant == "diagonal":  # diag(M)[i] = Σ_v C[i,v]²: purely local
        return [(c * c).sum(1) for c in c_local]
    raise ValueError(f"unknown PathSim variant {variant!r}")


def sharded_chain_outputs(first: list, rest: Sequence = (), mesh: Mesh = None,
                          axis: str = "dp", allpairs_strategy: str = "allgather",
                          want_m: bool = True):
    """(M row blocks, row sums) of a *symmetric* chain, sharded.

    ``first``: the row shards of the (padded) first half block; ``rest``:
    the remaining half-chain blocks, each replicated (:func:`replicate`).
    Returns each shard's rows of M (None unless ``want_m``) and each
    shard's row sums."""
    c_local = _fold_local(first, rest)
    rowsums = _denominators(c_local, mesh, "rowsum")
    if not want_m:
        return None, rowsums
    if allpairs_strategy == "allgather":
        c_full = all_gather(c_local, mesh)
        m = [c @ cf.T for c, cf in zip(c_local, c_full)]
    elif allpairs_strategy == "ring":
        m = ring_allpairs_rowblock(c_local, mesh)
    else:
        raise ValueError(f"unknown allpairs_strategy {allpairs_strategy!r}")
    return m, rowsums


def _resolve_use_kernel(use_kernel, first, rest, k: int) -> bool:
    if use_kernel is not None:
        return bool(use_kernel)
    v_out = rest[-1][0].shape[1] if rest else first[0].shape[1]
    n_rows = first[0].shape[0] * len(first)
    return resolve_ring_kernel(n_rows, v_out, k, first[0].device)


def shard_limbs(c_local: list, use_kernel: bool):
    """Each shard's u8 limbs as K3 reads them (None on the host or on the
    fold), split once per shard per graph."""
    if not use_kernel or c_local[0].device.type != "cuda":
        return None
    return [ck.kernel_limbs(c.to(torch.float32).contiguous())
            for c in c_local]


def sharded_topk(first: list, rest: Sequence = (), mesh: Mesh = None,
                 k: int = 10, n_true: int = 0, axis: str = "dp",
                 mask_self: bool = True, variant: str = "rowsum",
                 use_kernel: bool | None = None, limbs: list | None = None):
    """Distributed per-row top-k without any score block bigger than
    [n_loc, n_loc]: local half-chain fold, one ``psum`` for the column
    totals (the "rowsum" variant; "diagonal" is purely local), then the
    ring streams the peer C blocks and folds score tiles into each
    shard's running top-k (:func:`.ring.ring_topk_rowblock`).

    ``use_kernel``: None resolves through :func:`resolve_ring_kernel`.
    ``limbs``: the shards' limbs when the caller keeps them (else split
    here on the card). Returns (values, indices) per local shard."""
    use_kernel = _resolve_use_kernel(use_kernel, first, rest, k)
    c_local = _fold_local(first, rest)
    d_local = _denominators(c_local, mesh, variant)
    if limbs is None:
        limbs = shard_limbs(c_local, use_kernel)
    return ring_topk_rowblock(c_local, d_local, mesh, k=k, n_true=n_true,
                              mask_self=mask_self, use_kernel=use_kernel,
                              limbs=limbs)


def sharded_ring_state(first: list, rest: Sequence = (), mesh: Mesh = None,
                       axis: str = "dp", variant: str = "rowsum"):
    """The ring's fixed per-shard state: the folded local factor block
    and its denominator rows (one psum for "rowsum"). Cheap: recomputed
    on every resume, so checkpoints never persist O(N·V)."""
    c_local = _fold_local(first, rest)
    return c_local, _denominators(c_local, mesh, variant)


# One host-driven ring step over the mesh: the checkpointable unit of the
# stepwise pass. The JAX package wraps its step in a shard_map program;
# here the step already runs every local shard.
sharded_ring_step = ring_topk_step


def _roll_rows(parts: list, steps: int, mesh: Mesh, move=None) -> list:
    """The ring's rotating state after ``steps`` steps, rebuilt at resume:
    shard i holds the block of shard (i − steps) mod D, i.e. ``steps``
    rotations of the shard list."""
    for _ in range(steps % mesh.size):
        parts = ppermute(parts, mesh, move=move)
    return parts


def _put_rows(arr: np.ndarray, mesh: Mesh, like: torch.Tensor) -> list:
    """This process's row shards of a full host array (present on every
    process), in ``like``'s dtype."""
    n_loc = arr.shape[0] // mesh.size
    r0 = mesh.first_shard * n_loc
    local = arr[r0:r0 + n_loc * len(mesh.devices)]
    dtype = like.dtype if np.issubdtype(arr.dtype, np.floating) else None
    return split_rows(np.ascontiguousarray(local), mesh, dtype=dtype)


def sharded_topk_stepwise(first: list, rest: Sequence = (), mesh: Mesh = None,
                          k: int = 10, n_true: int = 0, axis: str = "dp",
                          mask_self: bool = True, variant: str = "rowsum",
                          use_kernel: bool | None = None, ckpt=None,
                          every: int = 1, limbs: list | None = None):
    """:func:`sharded_topk` with mid-ring checkpoint and resume: the ring
    runs one step per call from the host; every ``every`` steps the
    [N, k] running bests land in the checkpoint (unit
    ``ring_bests_after_{t}``). Resume reloads the newest unit, rebuilds C
    and the rotating block (a block-roll, never persisted) and goes on
    from step t + 1, so any kill point gives the arrays of
    :func:`sharded_topk`.

    ``ckpt``: a :class:`~..utils.checkpoint.CheckpointManager` (the
    caller's identity: graph digest, mesh size, compute path). A
    preemption request (SIGTERM) at a step boundary flushes the bests and
    raises :class:`~..resilience.Preempted` (exit 75 at the CLI)."""
    from .. import resilience
    from ..resilience.preemption import handler as _preemption

    use_kernel = _resolve_use_kernel(use_kernel, first, rest, k)
    n_dev = mesh.size
    c, d = sharded_ring_state(first, rest, mesh=mesh, axis=axis,
                              variant=variant)
    if limbs is None:
        limbs = shard_limbs(c, use_kernel)
    n_loc = c[0].shape[0]
    n_pad = n_loc * n_dev

    start = 0
    prev_key = None
    best_v = best_i = None
    if ckpt is not None:
        prefix = "ring_bests_after_"
        snaps = [key for key in ckpt.done_keys() if key.startswith(prefix)]
        if snaps:
            prev_key = max(snaps, key=lambda s: int(s[len(prefix):]))
            for stale in snaps:  # a crash between save(new) and drop(old)
                if stale != prev_key:
                    ckpt.drop_unit(stale)
            unit = ckpt.load_unit(prev_key)
            # the run's own dtype: an f64 run resumes in f64 (dtype is
            # part of the caller's checkpoint identity)
            best_v = _put_rows(np.asarray(unit["vals"]), mesh, c[0])
            best_i = _put_rows(np.asarray(unit["idxs"], dtype=np.int64),
                               mesh, c[0])
            start = int(prev_key[len(prefix):]) + 1
    if start == 0:
        best_v = _put_rows(np.full((n_pad, k), -np.inf), mesh, c[0])
        best_i = _put_rows(np.zeros((n_pad, k), dtype=np.int64), mesh, c[0])
    block = _roll_rows(c, start, mesh)
    d_block = _roll_rows(d, start, mesh)
    block_limbs = None
    if limbs is not None:
        from .ring import _limbs_to

        block_limbs = (_roll_rows(limbs, start, mesh, move=_limbs_to)
                       if not mesh.multiprocess
                       else [ck.kernel_limbs(b.to(torch.float32).contiguous())
                             for b in block])

    # Retries and one-process preemption flushes are sound only with one
    # controller: in a multi-process job every process must run the same
    # sequence of collectives, so a retry (or a flush) on one of them
    # would desynchronize the others. There the steps run bare; recovery
    # is job-level (restart every process; the checkpoint still resumes).
    single_controller = not mesh.multiprocess
    ids: dict = {}

    def _snapshot(after: int, prev_key):
        """Durable running-bests snapshot for resume at step after + 1;
        the superseded one goes only once the new one has landed."""
        new_key = f"ring_bests_after_{after}"
        ckpt.save_unit(new_key, vals=gather_rows(best_v, mesh),
                       idxs=gather_rows(best_i, mesh))
        if prev_key is not None and prev_key != new_key:
            ckpt.drop_unit(prev_key)
        return new_key

    for t in range(start, n_dev):
        # preemption point at a ring-step boundary: flush the bests so the
        # restart resumes at step t, not at the last `every` snapshot
        if single_controller and _preemption.requested():
            if ckpt is not None and t > start:
                prev_key = _snapshot(t - 1, prev_key)
            _preemption.check(
                checkpoint_dir=str(ckpt.dir) if ckpt is not None else None)

        # one ring step = one tile_execute attempt: the step returns new
        # carries, assigned on success, so a retry never folds twice
        def step(t=t, block=block, d_block=d_block, bv=best_v, bi=best_i,
                 bl=block_limbs):
            return sharded_ring_step(
                c, d, block, d_block, bv, bi, t, mesh, k=k, n_true=n_true,
                mask_self=mask_self, use_kernel=use_kernel, limbs=limbs,
                block_limbs=bl, rotate=t < n_dev - 1, row_ids_cache=ids)

        if single_controller:
            block, d_block, best_v, best_i, block_limbs = (
                resilience.resilient_call("tile_execute", step))
        else:
            block, d_block, best_v, best_i, block_limbs = step()
        if ckpt is not None and (t % every == every - 1 or t == n_dev - 1):
            prev_key = _snapshot(t, prev_key)
    return best_v, best_i
