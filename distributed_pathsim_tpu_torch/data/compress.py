"""Degree-sorted (hub-first) index permutations for compressed layouts.

The port's copy of the JAX package's ``data/compress.py`` (host numpy,
unchanged in behavior).

The COO factor chain's resident footprint is the fleet's scale ceiling
(~14 GB host RSS at 4.19M authors in the JAX package's
SCALE_4M_r03.json) — and both compression papers this lands from (arXiv
2409.02208, arXiv 1708.07271) make the same observation: a *reordered* sparse matrix compresses far
better than the raw one, because hub-first orderings concentrate the
used index range near zero (narrower integer dtypes, smaller
delta-encoded column gaps) and make adjacent rows structurally similar
(denser blocks).

This module computes those orderings and owns their algebra:

- :func:`degree_order` — the hub-first permutation of one index space
  (stable: equal degrees keep ascending original order, so the
  permutation is deterministic for a given degree vector).
- :class:`PermutationPair` — a permutation and its inverse as one
  value, with ``apply``/``invert`` for index arrays and an
  identity-``extend`` for capacity-padded/append-grown spaces: slots
  appended past the original size map to themselves, so a delta node
  append never re-permutes (and never re-encodes) existing data.
- :func:`hin_degree_permutations` — one pair per node type of an
  encoded HIN, from the summed degree of every adjacency block
  touching that type.
- :func:`factor_permutations` — row/col pairs for a single folded
  factor, from its own marginals (what ``ops/packed.py`` consumes).

**The permutation contract** (DESIGN.md §29): permutations are an
*encoding-internal* coordinate change. Every host-visible boundary —
labels, top-k tie order ``(desc score, asc global col)``, the JSONL
wire, checkpoint digests — speaks ORIGINAL ids; whoever applies a
permutation owns inverting it before anything escapes (ops/packed.py
inverts at every unpack/slice accessor, which is why every downstream
consumer is bit-identical by construction). Nothing in this module
mutates an :class:`~.encode.EncodedHIN`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def degree_order(deg: np.ndarray) -> np.ndarray:
    """Hub-first permutation of an index space: ``perm[new] = old``,
    sorted by (descending degree, ascending original index). The
    secondary key makes the order total and deterministic — two
    packings of the same factor are byte-identical."""
    deg = np.asarray(deg)
    # lexsort's last key is primary; negate for hub-first, index
    # ascending breaks ties deterministically.
    return np.lexsort(
        (np.arange(deg.shape[0]), -deg.astype(np.int64))
    ).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class PermutationPair:
    """A permutation and its inverse over one index space of size
    ``n``: ``perm[new] = old`` and ``inv[old] = new`` (so
    ``inv[perm] == arange(n)``). ``apply`` maps original ids to
    permuted ids; ``invert`` maps back — the two host-boundary
    directions, named so call sites read as what they do."""

    perm: np.ndarray
    inv: np.ndarray

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])

    @property
    def is_identity(self) -> bool:
        return bool((self.perm == np.arange(self.n)).all())

    def apply(self, idx: np.ndarray) -> np.ndarray:
        """Original ids → permuted ids."""
        return self.inv[np.asarray(idx, dtype=np.int64)]

    def invert(self, idx: np.ndarray) -> np.ndarray:
        """Permuted ids → original ids (the host-boundary direction)."""
        return self.perm[np.asarray(idx, dtype=np.int64)]

    def extend(self, n_new: int) -> "PermutationPair":
        """Identity-extend to a grown index space: slots in
        ``[n, n_new)`` map to themselves. This is the append contract —
        a headroom-padded node append must never re-permute existing
        slots (existing packed chunks would all re-encode and the
        O(Δ) delta path would become O(nnz))."""
        if n_new < self.n:
            raise ValueError(
                f"cannot shrink a permutation ({self.n} -> {n_new})"
            )
        if n_new == self.n:
            return self
        tail = np.arange(self.n, n_new, dtype=np.int64)
        return PermutationPair(
            perm=np.concatenate([self.perm, tail]),
            inv=np.concatenate([self.inv, tail]),
        )

    @staticmethod
    def identity(n: int) -> "PermutationPair":
        ar = np.arange(int(n), dtype=np.int64)
        return PermutationPair(perm=ar, inv=ar)

    @staticmethod
    def from_perm(perm: np.ndarray) -> "PermutationPair":
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
        return PermutationPair(perm=perm, inv=inv)


def hin_degree_permutations(hin) -> dict[str, PermutationPair]:
    """One hub-first :class:`PermutationPair` per node type, from the
    summed degree of every adjacency block incident to that type
    (rows of blocks where the type is source + cols where it is
    destination). Sized to each type's PADDED index space, so
    capacity-reserved slots (degree 0 by construction) sort last and
    an append inside the reserve only ever touches identity-mapped
    tail slots."""
    out: dict[str, PermutationPair] = {}
    for node_type, idx in hin.indices.items():
        deg = np.zeros(idx.padded_size, dtype=np.int64)
        for b in hin.blocks.values():
            if b.src_type == node_type and b.rows.shape[0]:
                np.add.at(deg, b.rows.astype(np.int64), 1)
            if b.dst_type == node_type and b.cols.shape[0]:
                np.add.at(deg, b.cols.astype(np.int64), 1)
        out[node_type] = PermutationPair.from_perm(degree_order(deg))
    return out


def factor_permutations(
    rows: np.ndarray, cols: np.ndarray, shape: tuple[int, int]
) -> tuple[PermutationPair, PermutationPair]:
    """(row pair, col pair) for one factor from its own marginals.
    The column permutation is the load-bearing one for the bit-packed
    layout: hub columns land at small permuted ids, so within-row
    delta gaps (and the max used column id, which picks the narrow
    dtype) shrink together. ``ops/packed.py``'s hot path computes
    exactly that column half inline (skipping the row sort it does
    not need — its row layout is chunk-local, derived from the count
    tables); this full pair is the audit/experimentation surface for
    layouts that DO reorder rows globally."""
    row_deg = np.bincount(
        np.asarray(rows, dtype=np.int64), minlength=int(shape[0])
    )
    col_deg = np.bincount(
        np.asarray(cols, dtype=np.int64), minlength=int(shape[1])
    )
    return (
        PermutationPair.from_perm(degree_order(row_deg)),
        PermutationPair.from_perm(degree_order(col_deg)),
    )
