"""Slice-aware half-chain factor build for partitioned serving.

One partition worker's arithmetic state is a *row slice* of the
half-chain factor ``C`` plus its slice of the denominator vector,
restricted to the rows the partition holds. The fold reuses the sparse
machinery (``ops/planner.fold_half``) over the partition's *sliced*
HIN: axis-type blocks carry only held rows' edges, so the fold touches
only held work and its COO output has support exclusively on held rows
(asserted, not assumed).

Denominators need one global exchange: for the rowsum variant,
``d = C · g`` with ``g = Σ_rows C`` summed over EVERY partition's rows.
Each holder computes the column-sum contribution of each range it holds
(exact integer sums, so contributions from different holders of the
same range are bit-identical and the router may take any one); the
router sums one contribution per range and broadcasts ``g`` back. Until
``g`` arrives a partition cannot score anything.

The slice lives on the host in exact f64, dense (``coo``) or packed
(``blocked`` / ``bitpacked``, ops/packed.py), as in the JAX package;
serving/partition.py mirrors the window it scores to the card. The
attributes named in :data:`FACTOR_SURFACE` are for this module and the
partition exchange layer only (tests/test_torch_hygiene.py checks it).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..data.partition import PartitionMap

# The factor-slice surface: attribute names that expose raw held-row
# factor state. Only the partition exchange layer (this module +
# serving/partition.py) may touch them; other package code reading them
# would read factor rows it does not own. ``packed_held`` is the
# compressed twin of ``c_held`` (the factor_format knob), same rules.
FACTOR_SURFACE = frozenset({
    "c_held", "packed_held", "held_slot_of", "range_slots",
})


@dataclasses.dataclass
class FactorSlice:
    """The held rows' factor slice and its row bookkeeping.

    The arithmetic state lives in exactly ONE of two layouts, chosen
    by the ``factor_format`` tuning knob at build: ``c_held`` — dense
    f64 [n_held, V] (exact integer counts, V = padded target width of
    the half chain) — or ``packed_held``, the compressed slot-space
    factor (ops/packed.py) whose windows decode transiently per op.
    ``rows`` is the global row ids of the slots in order;
    ``held_slot_of`` the inverse map (−1 = not held); ``range_slots``
    maps each held range index to its [lo, hi) slot window. Every
    consumer outside this module goes through the accessor methods, so
    the two layouts can never produce different numbers: both speak
    exact f64 integers in slot space.
    """

    c_held: np.ndarray | None
    rows: np.ndarray
    held_slot_of: np.ndarray
    range_slots: dict[int, tuple[int, int]]
    packed_held: object | None = None  # ops.packed.PackedFactor
    _v: int = 0
    factor_format: str = "coo"

    @property
    def v(self) -> int:
        if self._v:
            return int(self._v)
        if self.c_held is not None:  # direct-constructed dense slices
            return int(self.c_held.shape[1])
        return int(self.packed_held.shape[1])

    @property
    def n_held(self) -> int:
        if self.c_held is not None:
            return int(self.c_held.shape[0])
        return int(self.packed_held.shape[0])

    def holds(self, row: int) -> bool:
        return 0 <= row < self.held_slot_of.shape[0] and self.held_slot_of[row] >= 0

    # -- layout-independent arithmetic accessors ---------------------------
    #
    # Exact f64 integer arithmetic either way: the dense path slices
    # c_held, the packed path decodes windows through the sanctioned
    # ops/packed accessors — bit-identical numbers by construction.

    def window_dense(self, lo_slot: int, hi_slot: int) -> np.ndarray:
        """Dense f64 [hi−lo, V] view/materialization of a slot window
        (the partial_* GEMM operand)."""
        if self.c_held is not None:
            return self.c_held[lo_slot:hi_slot]
        from ..ops import packed as pkd

        span = pkd.row_slice(self.packed_held, lo_slot, hi_slot)
        out = np.zeros((hi_slot - lo_slot, self.v), dtype=np.float64)
        if span.rows.shape[0]:
            out[span.rows - lo_slot, span.cols] = span.weights
        return out

    def row_dense(self, slot: int) -> np.ndarray:
        """One held row's dense factor tile (the tile_pull payload)."""
        return self.window_dense(slot, slot + 1)[0]

    def window_colsum(self, lo_slot: int, hi_slot: int) -> np.ndarray:
        """Exact column sums of a slot window (colsum contributions)."""
        if self.c_held is not None:
            return self.c_held[lo_slot:hi_slot].sum(axis=0)
        from ..ops import packed as pkd

        span = pkd.row_slice(self.packed_held, lo_slot, hi_slot)
        out = np.zeros(self.v, dtype=np.float64)
        if span.rows.shape[0]:
            np.add.at(out, span.cols, span.weights)
        return out

    def matvec(self, g: np.ndarray) -> np.ndarray:
        """``C_held @ g`` over every held slot (denominator init)."""
        if self.c_held is not None:
            return self.c_held @ g
        from ..ops import packed as pkd

        return pkd.factor_rowsums_weighted(self.packed_held, g)

    def rows_matvec(self, slots: np.ndarray, g: np.ndarray) -> np.ndarray:
        """``C_held[slots] @ g`` (post-delta denominator re-encode)."""
        if self.c_held is not None:
            return self.c_held[slots] @ g
        from ..ops import packed as pkd

        return pkd.gather_rows_dense(self.packed_held, slots) @ g

    def factor_bytes(self) -> int:
        """Resident factor bytes as held — the number the max-N-per-
        partition curve divides the worker budget by."""
        if self.c_held is not None:
            return int(self.c_held.nbytes)
        from ..ops import packed as pkd

        return pkd.factor_bytes(self.packed_held)


def build_factor_slice(
    hin_slice, metapath, pmap: PartitionMap, held: tuple[int, ...],
    factor_format: str = "coo",
) -> FactorSlice:
    """Fold the (sliced) HIN's half chain and hold only the held rows
    — dense when ``factor_format == "coo"``, packed through the
    sanctioned ops/packed factory otherwise (a compressed slice
    divides into the per-worker memory budget, which is what raises
    max-N per partition). ``hin_slice`` must be the output of
    :func:`~..data.partition.slice_hin` for exactly ``held`` — the fold
    produces no support outside the held ranges, which is asserted, not
    assumed."""
    from ..ops import planner
    from ..ops import sparse as sp

    coo = planner.fold_half(hin_slice, metapath).summed()
    rows_list = []
    range_slots: dict[int, tuple[int, int]] = {}
    at = 0
    for g in held:
        lo, hi = pmap.range_of(g)
        rows_list.append(np.arange(lo, hi, dtype=np.int64))
        range_slots[g] = (at, at + (hi - lo))
        at += hi - lo
    rows = (
        np.concatenate(rows_list) if rows_list
        else np.empty(0, dtype=np.int64)
    )
    held_slot_of = np.full(pmap.n, -1, dtype=np.int64)
    held_slot_of[rows] = np.arange(rows.shape[0], dtype=np.int64)
    src = coo.rows.astype(np.int64)
    in_logical = src < pmap.n  # capacity-padded slots carry no rows
    src, cols, w = src[in_logical], coo.cols[in_logical], (
        coo.weights[in_logical]
    )
    slots = held_slot_of[src]
    if (slots < 0).any():
        raise ValueError(
            "sliced half chain has support outside the held ranges "
            "— slice_hin and build_factor_slice disagree on the axis"
        )
    if factor_format == "coo":
        c_held = np.zeros((rows.shape[0], coo.shape[1]), dtype=np.float64)
        if src.shape[0]:
            c_held[slots, cols] = w
        return FactorSlice(
            c_held=c_held, rows=rows, held_slot_of=held_slot_of,
            range_slots=range_slots, _v=int(coo.shape[1]),
            factor_format="coo",
        )
    from ..ops import packed as pkd

    packed_held = pkd.make_factor(
        sp.COOMatrix(
            rows=slots, cols=cols.astype(np.int64),
            weights=w.astype(np.float64),
            shape=(int(rows.shape[0]), int(coo.shape[1])),
        ),
        factor_format,
    )
    return FactorSlice(
        c_held=None, rows=rows, held_slot_of=held_slot_of,
        range_slots=range_slots, packed_held=packed_held,
        _v=int(coo.shape[1]), factor_format=factor_format,
    )


def range_colsums(
    fs: FactorSlice, held: tuple[int, ...]
) -> dict[int, dict]:
    """Per-held-range column-sum contributions as sparse wire payloads
    ``{range: {"cols": [...], "vals": [...]}}`` — exact integer sums,
    so any holder's contribution for a range equals any other's
    (whatever layout each holds its slice in)."""
    out = {}
    for g in held:
        lo, hi = fs.range_slots[g]
        colsum = fs.window_colsum(lo, hi)
        nz = np.flatnonzero(colsum)
        out[g] = {
            "cols": [int(c) for c in nz],
            "vals": [float(colsum[c]) for c in nz],
        }
    return out


def patch_factor_slice(fs: FactorSlice, delta_c, n_logical: int) -> np.ndarray:
    """Apply a signed half-chain delta (``ops.sparse.COOMatrix``,
    support restricted to held rows) to the slice in place — a dense
    scatter-add, or the packed layouts' chunk-granular
    ``patch_factor`` (both O(Δ)-row-granular, both recompile-free:
    nothing here touches a device shape). Returns the sorted global
    rows whose factor row changed — the rows whose denominators must
    be recomputed against the new global colsum."""
    if delta_c.rows.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    src = delta_c.rows.astype(np.int64)
    in_logical = src < n_logical
    src = src[in_logical]
    cols = delta_c.cols[in_logical]
    w = delta_c.weights[in_logical]
    slots = fs.held_slot_of[src]
    if (slots < 0).any():
        raise ValueError(
            "half-chain delta touches rows this partition does not hold "
            "— the router's delta filter and the slice disagree"
        )
    if fs.c_held is not None:
        np.add.at(fs.c_held, (slots, cols), w.astype(np.float64))
    else:
        from ..ops import packed as pkd
        from ..ops import sparse as sp

        fs.packed_held = pkd.patch_factor(
            fs.packed_held,
            sp.COOMatrix(
                rows=slots, cols=cols.astype(np.int64),
                weights=w.astype(np.float64),
                shape=(fs.n_held, fs.v),
            ),
        )
    return np.unique(src)
