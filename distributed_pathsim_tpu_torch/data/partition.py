"""Row-range partitioning of an encoded HIN: ownership, slicing, routing.

The half-chain factorization M = C·Cᵀ is *row-separable*: row ``i`` of
the factor ``C = A₁·A₂·…`` depends only on node ``i``'s own edges in
the first (axis-type) block of the chain — every later block is shared.
That is what makes a bigger-than-one-worker graph servable: partition
the SOURCE-type rows into contiguous ranges, give each worker only its
ranges' slice of the axis blocks (plus the whole of every non-axis
block, which is small for DBLP-shaped HINs), and the worker can compute
its slice of any pairwise row ``M[s, :]`` from the source's factor row
``C[s, :]`` alone — a V-length tile that travels on the wire.

:class:`PartitionMap` is the geometry the replica router's range policy
routes by (router/hashring.py) and the partitioned fleet holds its
slices by (serving/partition.py, router/partition.py).

Three pieces:

- :class:`PartitionMap` — the ownership geometry: ``n`` logical rows
  split into ``p`` contiguous ceil-division ranges, the SAME geometry
  :class:`~..router.hashring.RangeRouter` routes by (one shared
  definition, so routing and ownership can never disagree). Replication
  is chained: the worker at partition index ``i`` holds ranges
  ``i, i+1, …, i+r−1 (mod p)``, so every range survives ``r−1`` worker
  deaths.
- :func:`slice_hin` — an :class:`EncodedHIN` whose axis-type adjacency
  entries are filtered to the held ranges. Index spaces stay FULL
  (global row numbering, label resolution, block shapes all unchanged)
  — only edge storage shrinks, which is where the memory goes.
- :func:`filter_axis_edges` — the delta-routing filter: restrict a
  wire-level edge-delta record set to the rows a partition holds, so a
  routed update is applied exactly by the holders of its rows and
  nobody else (O(Δ) per owning partition).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .encode import EncodedHIN


@dataclasses.dataclass(frozen=True)
class PartitionMap:
    """Contiguous ceil-division row ranges over ``n`` logical rows.

    Range ``g`` is ``[g·span, min((g+1)·span, n))`` with
    ``span = ceil(n / p)`` — identical to RangeRouter's split, and
    ``owner_of`` clamps to the last partition exactly as its routing
    does, so a row is owned by the partition its queries route to.
    Ranges can be empty when ``n < p``; holders of an empty range
    simply have no rows there.
    """

    n: int
    p: int

    def __post_init__(self):
        if self.p < 1:
            raise ValueError(f"need at least one partition, got {self.p}")
        if self.n < 1:
            raise ValueError(f"need at least one row, got {self.n}")

    @property
    def span(self) -> int:
        return -(-self.n // self.p)  # ceil division

    def range_of(self, g: int) -> tuple[int, int]:
        """Half-open row range ``[lo, hi)`` of partition ``g``."""
        if not 0 <= g < self.p:
            raise ValueError(f"partition {g} out of range [0, {self.p})")
        lo = min(g * self.span, self.n)
        hi = min((g + 1) * self.span, self.n)
        if g == self.p - 1:
            hi = self.n  # the tail partition absorbs any remainder
        return lo, hi

    def owner_of(self, row: int) -> int:
        """Partition index owning ``row``."""
        if not 0 <= row < self.n:
            raise ValueError(f"row {row} out of range [0, {self.n})")
        return min(row // self.span, self.p - 1)

    def ranges(self) -> tuple[tuple[int, int], ...]:
        return tuple(self.range_of(g) for g in range(self.p))

    def held_by(self, part_index: int, replication: int) -> tuple[int, ...]:
        """Range indices the worker at ``part_index`` holds under
        chained replication: its own range plus the next
        ``replication−1`` (mod p), deduplicated in hold order."""
        r = max(1, min(int(replication), self.p))
        out = []
        for j in range(r):
            g = (part_index + j) % self.p
            if g not in out:
                out.append(g)
        return tuple(out)

    def holders_of(self, g: int, replication: int) -> tuple[int, ...]:
        """Partition (= worker) indices holding range ``g``, owner
        first, then the mirrors in chained order — the preference order
        failover walks."""
        r = max(1, min(int(replication), self.p))
        out = []
        for j in range(r):
            w = (g - j) % self.p
            if w not in out:
                out.append(w)
        return tuple(out)

    def rows_held(self, part_index: int, replication: int) -> int:
        return sum(
            hi - lo
            for lo, hi in (
                self.range_of(g)
                for g in self.held_by(part_index, replication)
            )
        )


def _row_mask(values: np.ndarray, ranges) -> np.ndarray:
    mask = np.zeros(values.shape[0], dtype=bool)
    for lo, hi in ranges:
        mask |= (values >= lo) & (values < hi)
    return mask


def slice_hin(hin: EncodedHIN, axis_type: str, ranges) -> EncodedHIN:
    """The partition's resident graph: every adjacency block whose
    source (or destination) type is ``axis_type`` keeps only the edges
    whose axis endpoint falls in ``ranges``; every other block is kept
    whole. Index spaces, shapes, and schema are untouched — global row
    numbering survives, so factor rows, wire payloads, and label
    resolution need no translation layer."""
    ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)
    blocks = {}
    for rel, b in hin.blocks.items():
        src_t, dst_t = hin.schema.relations[rel]
        keep = None
        if src_t == axis_type:
            keep = _row_mask(b.rows, ranges)
        if dst_t == axis_type:
            dmask = _row_mask(b.cols, ranges)
            keep = dmask if keep is None else (keep & dmask)
        if keep is None or bool(keep.all()):
            blocks[rel] = b
            continue
        blocks[rel] = dataclasses.replace(
            b, rows=b.rows[keep], cols=b.cols[keep],
        )
    return EncodedHIN(
        schema=hin.schema, indices=hin.indices, blocks=blocks,
        name=hin.name,
    )


def filter_axis_edges(
    hin: EncodedHIN, axis_type: str, ranges,
    add_edges=(), remove_edges=(),
) -> tuple[list, list]:
    """Restrict wire-level edge records to the rows this partition
    holds. Records on axis-type relationships keep only endpoints in
    ``ranges``; records on shared (non-axis) relationships pass through
    untouched — every partition applies those. Endpoints given by id
    are resolved through the (full) index spaces first."""
    ranges = tuple((int(lo), int(hi)) for lo, hi in ranges)

    def _held(row: int) -> bool:
        return any(lo <= row < hi for lo, hi in ranges)

    def _resolve(node_type: str, rec: dict, end: str) -> int:
        row = rec.get(f"{end}_row")
        if row is not None:
            return int(row)
        return hin.resolve_source(node_type, node_id=rec.get(end))

    def _filter(records) -> list:
        out = []
        for rec in records:
            rel = rec.get("rel")
            if rel not in hin.schema.relations:
                out.append(rec)  # let the delta machinery reject it loudly
                continue
            src_t, dst_t = hin.schema.relations[rel]
            if src_t == axis_type and not _held(_resolve(src_t, rec, "src")):
                continue
            if dst_t == axis_type and not _held(_resolve(dst_t, rec, "dst")):
                continue
            out.append(rec)
        return out

    return _filter(add_edges), _filter(remove_edges)
