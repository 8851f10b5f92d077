"""Commuting-matrix chain evaluation.

The reference computes one entry (or one row sum) of the commuting matrix
per distributed 4-way join, ``2N-1`` joins per run (``DPathSim_APVPA.py:
28-68``). Here the chain is evaluated as staged matmuls — O(1) GEMMs for
the whole all-pairs problem. Functions take numpy arrays (the f64 oracle)
or torch tensors (the device backend) alike: they only use operators and
methods the two libraries share.

Key identities used throughout (SURVEY.md §3.3, verified against the
reference's own run log):

- symmetric path:  M = C @ Cᵀ,  C = product of the first half
- row sums without M:  rowsum(M) = C @ (Σ_x C[x, :])   (symmetric)
                       rowsum(M) = B₁ @ (B₂ @ … (Bₖ @ 1))  (general)
- pairwise row:  M[s, :] = (C[s, :] @ Cᵀ)  — one GEMV
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..data.encode import EncodedHIN
from .metapath import Step


# f32 represents every integer exactly up to 2**24. Path counts are
# integers (SURVEY.md §7 hard parts): a silently rounded count corrupts
# every downstream score, so backends refuse loudly past this range.
F32_EXACT_INT_MAX = float(2**24)


def _is_float32(dtype: Any) -> bool:
    """True for numpy's or torch's float32 (torch dtypes are not numpy
    dtypes, so compare by name)."""
    return str(dtype).rsplit(".", 1)[-1] == "float32"


def check_exact_counts(max_count: float, dtype: Any) -> None:
    """Refuse when integer path counts exceed the exact-integer range of
    the carry dtype (single shared guard — keep every backend's contract
    identical). float64 is real float64 here, on the host and on the
    card, so only float32 is guarded."""
    if not _is_float32(dtype):
        return
    if max_count >= F32_EXACT_INT_MAX:
        raise OverflowError(
            "path counts exceed f32 exact-integer range (2^24); "
            "pass --approx (exact_counts=False) to waive the guard, or "
            "construct with dtype=torch.float64 for exact single-source "
            "rows (all-pairs on the card stays f32 and keeps this guard; "
            "the dense backend's rank-all needs neither: past 2^24 it "
            "ranks by f64 scores of the exact counts)"
        )


def oriented_dense_blocks(
    hin: EncodedHIN,
    steps: Sequence[Step],
    dtype: Any = np.float64,
) -> list[np.ndarray]:
    """Materialize the oriented dense adjacency block for each step
    (host-side numpy; backends move/convert as needed)."""
    out = []
    for st in steps:
        b = hin.block(st.relationship)
        dense = b.to_dense(dtype=dtype)
        out.append(dense.T if st.reverse else dense)
    return out


def chain_product(blocks: Sequence[Any]):
    """Left-to-right product of the oriented chain."""
    m = blocks[0]
    for b in blocks[1:]:
        m = m @ b
    return m


def commuting_matrix_from_half(c):
    """M = C @ Cᵀ (symmetric by construction)."""
    return c @ c.T


def rowsums_from_half(c):
    """rowsum(M) = C @ (Σ_x C[x, :]) — the reference's "global walk" for
    every node at once, without materializing M. O(N·V) instead of O(N²)."""
    return c @ c.sum(0)


def rowsums_general(blocks: Sequence[Any]):
    """rowsum(M) for an arbitrary oriented chain: fold the all-ones vector
    from the right — never materializes anything wider than a block.
    The ones vector takes the block's dtype (and, for a tensor, its
    device)."""
    last = blocks[-1]
    if hasattr(last, "new_ones"):  # torch tensor
        v = last.new_ones(last.shape[-1])
    else:
        v = np.ones(last.shape[-1], dtype=last.dtype)
    for b in reversed(blocks):
        v = b @ v
    return v


def pairwise_row_from_half(c, source_index: int):
    """M[source, :] = C[source] @ Cᵀ — one GEMV, the batched analog of the
    reference's per-pair motif query."""
    return c @ c[source_index]
