"""2-D block-tiled all-pairs scoring over a (dp, tp) mesh.

A 1-D row sharding still makes every shard hold a full [n_loc, N] strip
of the score matrix; 2-D tiling shards both axes: shard (i, j) owns the
[N/dp, N/tp] tile ``S[i·N/dp:, j·N/tp:] = 2·(C_i C_jᵀ) / (d_i ⊕ d_j)``,
so per-shard memory falls as 1/(dp·tp).

The C blocks arrive pre-placed (rows over dp for the left operand, over
tp for the right), so the product needs no collective. The distributed
top-k reduces each shard's tile locally to k candidates and gathers only
those over tp. In the JAX package only its tests and the hybrid mesh
call these; so here. One process drives the grid (a multi-process 2-D
mesh is refused).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sparse import chunked_row_topk
from .mesh import Mesh, pad_to_multiple


def _single(mesh: Mesh) -> None:
    if mesh.multiprocess:
        raise ValueError("2-D tiling runs on a one-process mesh")


def place_2d(c, rowsums, mesh: Mesh, axes: tuple[str, str] = ("dp", "tp"),
             dtype=None):
    """Pad and place the half-chain factor twice: row blocks over dp for
    shard (i, j)'s left operand, over tp for its right one, and the
    denominators to match. Padding rows are zero → denominator 0 → score
    0 (then masked as columns). Returns per-shard lists (flat shard
    order) ``(c_row, c_col, d_row, d_col)``."""
    _single(mesh)
    dp, tp = (mesh.shape[a] for a in axes)
    c = np.asarray(c)
    rowsums = np.asarray(rowsums)
    n = c.shape[0]
    n_pad = pad_to_multiple(n, int(np.lcm(dp, tp)))
    if n_pad != n:
        c = np.pad(c, ((0, n_pad - n), (0, 0)))
        rowsums = np.pad(rowsums, (0, n_pad - n))
    ct = torch.as_tensor(c)
    dt = torch.as_tensor(rowsums)
    if dtype is not None:
        ct, dt = ct.to(dtype), dt.to(dtype)
    r, q = n_pad // dp, n_pad // tp
    c_row, c_col, d_row, d_col = [], [], [], []
    for s, dev in enumerate(mesh.devices):
        i, j = divmod(s, tp)
        c_row.append(ct[i * r:(i + 1) * r].to(dev))
        d_row.append(dt[i * r:(i + 1) * r].to(dev))
        c_col.append(ct[j * q:(j + 1) * q].to(dev))
        d_col.append(dt[j * q:(j + 1) * q].to(dev))
    return c_row, c_col, d_row, d_col


def _score_tile(ci, cj, di, dj):
    """One score tile: 2·(C_i C_jᵀ) / (d_i ⊕ d_j), zero where the
    denominator is zero."""
    m = ci @ cj.T
    denom = di[:, None] + dj[None, :]
    return torch.where(denom > 0,
                       (2.0 * m) / torch.where(denom > 0, denom, 1.0), 0.0)


def tiled_scores_2d(c_row, c_col, d_row, d_col, mesh: Mesh,
                    axes: tuple[str, str] = ("dp", "tp")) -> list:
    """All-pairs scores as the (dp, tp) grid of tiles, flat shard order."""
    _single(mesh)
    return [_score_tile(*a) for a in zip(c_row, c_col, d_row, d_col)]


def assemble_2d(tiles: list, mesh: Mesh,
                axes: tuple[str, str] = ("dp", "tp")) -> np.ndarray:
    """The full host matrix of a (dp, tp) grid of tiles."""
    tp = mesh.shape[axes[1]]
    rows = [torch.cat([t.cpu() for t in tiles[i:i + tp]], 1)
            for i in range(0, len(tiles), tp)]
    return torch.cat(rows).numpy()


def tiled_topk_2d(c_row, c_col, d_row, d_col, mesh: Mesh, k: int,
                  n_true: int, axes: tuple[str, str] = ("dp", "tp")):
    """Distributed top-k: each tile's local top-k, then a merge over the
    tp axis. Returns (values [N_pad, k], indices [N_pad, k]) on the host,
    ordered (descending score, ascending column). Self pairs and padding
    columns (>= n_true) are masked; real zero-degree targets keep score
    0. ``k`` past the merged candidate width pads with −inf columns."""
    _single(mesh)
    dp, tp = (mesh.shape[a] for a in axes)
    n_loc_r = c_row[0].shape[0]
    n_loc_c = c_col[0].shape[0]
    kk = min(k, n_loc_c)
    out_v, out_i = [], []
    for i in range(dp):
        cand_v, cand_i = [], []
        for j in range(tp):
            s_idx = i * tp + j
            s = _score_tile(c_row[s_idx], c_col[s_idx], d_row[s_idx],
                            d_col[s_idx])
            rows = i * n_loc_r + torch.arange(n_loc_r, device=s.device)
            cols = j * n_loc_c + torch.arange(n_loc_c, device=s.device)
            drop = (cols >= n_true)[None, :] | (rows[:, None] == cols[None, :])
            s = s.masked_fill(drop, float("-inf"))
            v, ix = chunked_row_topk(s, cols.expand(n_loc_r, n_loc_c), kk)
            home = c_row[i * tp].device
            cand_v.append(v.to(home))
            cand_i.append(ix.to(home))
        # candidates of every column tile of this row block, in tp order
        cv, ci = torch.cat(cand_v, 1), torch.cat(cand_i, 1)
        k_avail = min(k, kk * tp)
        top_v, top_p = _stable_top(cv, k_avail)
        top_i = torch.gather(ci, 1, top_p)
        if k_avail < k:
            top_v = torch.nn.functional.pad(top_v, (0, k - k_avail),
                                            value=float("-inf"))
            top_i = torch.nn.functional.pad(top_i, (0, k - k_avail))
        out_v.append(top_v.cpu())
        out_i.append(top_i.cpu())
    return torch.cat(out_v).numpy(), torch.cat(out_i).numpy()


def _stable_top(v: torch.Tensor, k: int):
    """``lax.top_k``'s order: descending, ties to the lower position."""
    p = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v, 1, p), p
