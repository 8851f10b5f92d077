"""Ring all-pairs: peer row blocks of C rotate around the mesh.

The ring-attention pattern applied to the author axis of the commuting
matrix: each shard holds one row block of the half-chain factor ``C``;
the peer block rotates around the ring while each shard folds one
``C_local @ C_peerᵀ`` tile per step. All of ``M`` (N×N) and all of ``C``
never exist on one device.

The JAX package runs these loops inside ``shard_map``; here one process
steps every shard of the mesh in turn and rotates the blocks with
:func:`.mesh.ppermute`. Each ring step's score-and-extract runs on K3
(``cuda_kernels.fused_topk_twopass_rect``, the same kernel the
single-card tiers use) wherever K3 takes the shape, or on the torch fold
(an f32 GEMM, an IEEE division and ``chunked_row_topk``) where it does
not. Both break ties by the lowest global column, so they agree bit for
bit.
"""

from __future__ import annotations

import torch

from ..ops import cuda_kernels as ck
from ..ops.sparse import chunked_row_topk
from .mesh import Mesh, ppermute


def ring_allpairs_rowblock(c_parts: list[torch.Tensor],
                           mesh: Mesh) -> list[torch.Tensor]:
    """Every shard's row block of M = C Cᵀ by rotating the peer blocks.

    c_parts: this process's shards of C, each [n_loc, V]. Returns each
    shard's [n_loc, D · n_loc] rows of M (padded N)."""
    n_dev = mesh.size
    n_loc = c_parts[0].shape[0]
    m = [torch.zeros((n_loc, n_dev * n_loc), dtype=c.dtype, device=c.device)
         for c in c_parts]
    block = list(c_parts)
    for t in range(n_dev):
        for s, (c, b) in enumerate(zip(c_parts, block)):
            # after t rotations shard `my` holds the block of (my - t)
            owner = (mesh.first_shard + s - t) % n_dev
            m[s][:, owner * n_loc:(owner + 1) * n_loc] = c @ b.T
        if t < n_dev - 1:  # the last rotation would move nothing used
            block = ppermute(block, mesh)
    return m


def _merge_topk_by_col(merged_v: torch.Tensor, merged_i: torch.Tensor,
                       k: int):
    """Top-k of each row of ``merged_v``, ties broken by ascending global
    column ``merged_i``: the oracle's stable ``argsort(-scores)`` order.
    Two stable sorts make the (−score, column) key, so the result does
    not depend on a tie's merge position (the shard's place in the ring
    or the shard count); ``torch.topk`` keeps no tie order on the card."""
    by_col = torch.sort(merged_i, dim=1, stable=True).indices
    v = torch.gather(merged_v, 1, by_col)
    i = torch.gather(merged_i, 1, by_col)
    by_val = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v, 1, by_val), torch.gather(i, 1, by_val)


def _limbs_to(limbs, device):
    """A shard's u8 limbs (:class:`cuda_kernels.Limbs`) on ``device``: the
    host fields stay, the planes and tile maxima move with the block."""
    if limbs is None:
        return None
    return limbs._replace(**{
        f: getattr(limbs, f).to(device, non_blocking=True)
        for f in ("planes", "counts", "rmax", "sub", "blocks", "order",
                  "wide_order", "narrow_order")
    })


def rotate_limbs(limbs: list, blocks: list[torch.Tensor], mesh: Mesh) -> list:
    """The limbs of the blocks after one :func:`.mesh.ppermute`. Inside the
    process they travel with their blocks; a block that crossed from
    another process (``blocks`` already rotated) is split again on
    arrival, which gives the same limbs."""
    if limbs is None:
        return None
    if not mesh.multiprocess:
        return ppermute(limbs, mesh, move=_limbs_to)
    moved = [None] + [_limbs_to(limbs[j - 1], mesh.devices[j])
                      for j in range(1, len(limbs))]
    moved[0] = ck.kernel_limbs(blocks[0])
    return moved


def ring_topk_rowblock(c_parts, d_parts, mesh: Mesh, k: int, n_true: int,
                       mask_self: bool = True, use_kernel: bool = False,
                       limbs: list | None = None):
    """Per-row top-k PathSim scores of every shard's row block, streaming
    the peer blocks around the ring: at each of the D steps a shard
    scores one [n_loc, n_loc] tile, folds it into its running [n_loc, k]
    best and passes the peer block on. Peak memory per shard is
    O(n_loc · (V + k)) on K3 (O(n_loc²) on the fold).

    ``use_kernel``: each step's score-and-extract runs on K3 (its plain
    version on a CPU shard); otherwise on the torch fold. ``limbs``: each
    shard's u8 limbs (:func:`cuda_kernels.kernel_limbs`), rotated with the
    blocks so that no step splits a block again.

    c_parts / d_parts: this process's shards of C [n_loc, V] and of the
    denominators [n_loc]. Returns (values, indices) per shard, [n_loc, k]
    each, indices global columns (int64)."""
    best_v = [torch.full((c.shape[0], k), float("-inf"), dtype=c.dtype,
                         device=c.device) for c in c_parts]
    best_i = [torch.zeros((c.shape[0], k), dtype=torch.int64,
                          device=c.device) for c in c_parts]
    block, d_block, block_limbs = list(c_parts), list(d_parts), limbs
    ids: dict = {}
    for t in range(mesh.size):
        block, d_block, best_v, best_i, block_limbs = ring_topk_step(
            c_parts, d_parts, block, d_block, best_v, best_i, t, mesh,
            k=k, n_true=n_true, mask_self=mask_self, use_kernel=use_kernel,
            limbs=limbs, block_limbs=block_limbs,
            rotate=t < mesh.size - 1, row_ids_cache=ids,
        )
    return best_v, best_i


def _row_ids(n_loc: int, device, cache: dict) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """K3's row ids for a shard's own block (``arange(n_loc)``: column ==
    row id is the self pair) and for a peer's (−1 matches no column),
    made once per device."""
    ids = cache.get(device)
    if ids is None:
        ids = cache[device] = (
            torch.arange(n_loc, dtype=torch.int32, device=device),
            torch.full((n_loc,), -1, dtype=torch.int32, device=device),
        )
    return ids


def ring_topk_step(c_parts, d_parts, block, d_block, best_v, best_i, t: int,
                   mesh: Mesh, k: int, n_true: int, mask_self: bool = True,
                   use_kernel: bool = False, limbs: list | None = None,
                   block_limbs: list | None = None, rotate: bool = True,
                   row_ids_cache: dict | None = None):
    """ONE ring step on every local shard: fold the held peer block's
    score tile into the running bests, then rotate. The stepwise pass
    (parallel/sharded.sharded_topk_stepwise) runs this same fold per
    step: after t steps shard i holds the block of shard (i − t) mod D,
    a block-roll of C rebuilt at resume, never persisted. ``rotate``:
    False on the last step, whose rotation nothing reads;
    ``row_ids_cache``: K3's row ids per device, kept across the steps.

    Returns the next (block, d_block, best_v, best_i, block_limbs)."""
    n_dev = mesh.size
    ids_cache = {} if row_ids_cache is None else row_ids_cache
    out_v, out_i = [], []
    for s, c in enumerate(c_parts):
        my = mesh.first_shard + s
        n_loc = c.shape[0]
        owner = (my - t) % n_dev
        col0 = owner * n_loc
        if use_kernel:
            own, peer = _row_ids(n_loc, c.device, ids_cache)
            # Self pairs exist only while a shard holds its own block;
            # n_true_cols=n_loc masks only K3's own ragged edge, and the
            # ring's padding (global column >= n_true, all in the last
            # owner's block) is masked after the owner offset.
            row_ids = own if (mask_self and owner == my) else peer
            lim = None
            if limbs is not None and block_limbs is not None:
                lim = (limbs[s], block_limbs[s])
            tile_v, tile_loc = ck.fused_topk_twopass_rect(
                c, block[s], d_parts[s], d_block[s], row_ids, k=k,
                n_true_cols=n_loc, limbs=lim,
            )
            tile_i = col0 + tile_loc
            tile_v = tile_v.to(best_v[s].dtype).masked_fill(
                tile_i >= n_true, float("-inf"))
        else:
            tile_v, tile_i = _fold_tile(c, d_parts[s], block[s], d_block[s],
                                        my * n_loc, col0, k, n_true,
                                        mask_self)
        v, i = _merge_topk_by_col(torch.cat([best_v[s], tile_v], 1),
                                  torch.cat([best_i[s], tile_i], 1), k)
        out_v.append(v)
        out_i.append(i)
    if rotate:
        block = ppermute(block, mesh)
        d_block = ppermute(d_block, mesh)
        block_limbs = rotate_limbs(block_limbs, block, mesh)
    return block, d_block, out_v, out_i, block_limbs


def _fold_tile(c, d, block, d_block, row0: int, col0: int, k: int,
               n_true: int, mask_self: bool):
    """The torch fold of one ring step: the [n_loc, n_loc] score tile in
    the factor's dtype (f32 GEMM in true f32, IEEE division), padding and
    self pairs at −inf, narrowed to k candidates by ``chunked_row_topk``
    (ascending-column tie-breaks, as the merge) before the merge."""
    m = c @ block.T
    denom = d[:, None] + d_block[None, :]
    s = torch.where(denom > 0,
                    (2.0 * m) / torch.where(denom > 0, denom, 1.0), 0.0)
    n_loc, n_cols = s.shape
    cols = col0 + torch.arange(n_cols, device=s.device)
    drop = (cols >= n_true)[None, :].expand(n_loc, n_cols)
    if mask_self:
        rows = row0 + torch.arange(n_loc, device=s.device)
        drop = drop | (rows[:, None] == cols[None, :])
    s = s.masked_fill(drop, float("-inf"))
    return chunked_row_topk(s, cols.expand(n_loc, n_cols), k)
