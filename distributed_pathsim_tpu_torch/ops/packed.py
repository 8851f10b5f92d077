"""Compressed sparse factor layouts: blocked-CSR and bit-packed chunks.

The resident COO half-chain factor is 24 bytes/nnz (int64 rows + int64
cols + f64 weights) — the fleet's scale ceiling (~14 GB host RSS at
4.19M authors in the JAX package's SCALE_4M_r03.json; in partition mode
it divides straight into each worker's budget). Both compression papers in PAPERS.md
(arXiv 2409.02208, arXiv 1708.07271) land the same move: *reorder*,
then store narrow. This module implements it as first-class factor
representations behind one sanctioned factory:

- ``blocked``: row-chunked CSR. Per chunk of ``chunk_rows`` rows:
  a per-row count table, column ids in the hub-first PERMUTED column
  space (data/compress.py) as the narrowest uint that fits the chunk's
  actual index range, weights as the narrowest uint that fits the
  chunk's actual count range (f64 fallback for non-integer data —
  loud, never lossy). Typically 3-6 bytes/nnz.
- ``bitpacked``: ``blocked`` plus bit-level column packing: within
  each chunk, rows are laid out hub-first and their permuted column
  ids delta-encoded (first column absolute, then gap−1), then packed
  into fixed-width blocks of ``_BLOCK_NNZ`` values — each block
  stores its own bit width, so hub blocks (dense rows, tiny gaps)
  pack at 2-5 bits/value while tail blocks pay only for themselves.
  Typically 1.5-3 bytes/nnz.

**Hard contracts.** (1) Bit parity: every accessor returns ORIGINAL
ids and exact f64 integer weights — ``as_coo(make_factor(c, fmt))``
is the canonical (row-major sorted, coalesced, zero-free) form of
``c``, so counts, f64 scores, and top-k tie order downstream are
bit-identical to the COO path by construction; the permutations of
data/compress.py never escape this module. (2) Recompile/realloc
stability: every chunk buffer is allocated at a pow-2 capacity bucket
(floor ``_PACK_BUCKET_FLOOR``), so a delta patch that drifts a chunk's
nnz inside its bucket rewrites in place-sized arrays — resident bytes
and downstream scatter-pad buckets stay put, which is what keeps the
delta path recompile-free. (3) O(Δ) patches: ``patch_factor``
re-encodes only the chunks a delta touches (the same row-granular
contract ``ops.sparse.coo_apply_delta`` has).

**Boundary.** The chunk internals below are the compressed layout's
private coordinate system. The ONLY sanctioned surface is
``SANCTIONED_FACTORY``; tests/test_torch_hygiene.py reads
``PACKED_SURFACE``/``SANCTIONED_FACTORY`` out of this module and
asserts no port module outside the factor modules touches the layout
attributes or the private constructors — a module that reads
``.chunks`` directly would be reading permuted-space ids as if they
were global columns, which is exactly the silent corruption the
boundary exists to prevent.

This is the port's copy of the JAX package's ``ops/packed.py`` (host
numpy): the chunk layout is the JAX package's byte for byte — the same
pow-2 capacity buckets, narrow dtypes and bit blocks — so
``content_digest`` and ``factor_bytes`` of a port factor equal the JAX
package's for the same COO.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..data.compress import PermutationPair, degree_order
from . import sparse as sp

# Rows per chunk: the re-encode granularity of a delta patch and the
# natural alignment of the torch-sparse tile extraction (backends pass
# their tile_rows). A layout invariant, not a measured perf knob — the
# measured knob is `factor_format` in tuning/registry.py.
_PACK_CHUNK_ROWS = 4096
# Values per fixed-width bit-packing block (bitpacked format): each
# block stores its own bit width, so this is the granularity of the
# width adaptation. Layout invariant (sanctioned in the registry).
_BLOCK_NNZ = 256
# Pow-2 capacity bucket floor for chunk buffers: allocations never
# shrink below this, so tiny chunks don't fragment and delta-drifted
# nnz stays inside one bucket (sanctioned in the registry).
_PACK_BUCKET_FLOOR = 64

FACTOR_FORMATS = ("coo", "blocked", "bitpacked")

# Attribute surface of the packed representation (the hygiene test's
# registry, as COMPACTION_SURFACE/PROTOCOL_OPS): reading these
# outside the factor modules means consuming permuted-space layout
# internals as if they were graph data.
PACKED_SURFACE = frozenset({"chunks", "row_counts", "block_bits", "col_perm"})

# The sanctioned doorway: every function name here is a public
# factory/accessor whose outputs speak ORIGINAL ids; anything else of
# this module's layout is private to the factor modules.
SANCTIONED_FACTORY = frozenset({
    "make_factor", "as_coo", "row_slice", "row_range_nnz",
    "gather_rows_dense", "factor_colsum", "factor_rowsums_weighted",
    "factor_diag", "factor_bytes", "factor_nnz", "patch_factor",
    "packed_matmul", "fold_half", "is_packed", "is_canonical",
    "content_digest",
})


def _bits_needed(v: np.ndarray) -> np.ndarray:
    """Bits to represent each value (min 1 — a zero still occupies a
    slot in its block)."""
    v = np.asarray(v, dtype=np.uint64)
    out = np.ones(v.shape, dtype=np.uint8)
    nz = v > 0
    if nz.any():
        out[nz] = np.floor(np.log2(v[nz].astype(np.float64))).astype(
            np.uint8
        ) + 1
    return out


def _bucket_capacity(n: int) -> int:
    """Pow-2 capacity bucket ≥ n (floored): the realloc-stability
    contract of chunk buffers."""
    n = max(int(n), _PACK_BUCKET_FLOOR)
    return 1 << (n - 1).bit_length()


def _narrow_uint_dtype(max_value: int):
    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        if max_value <= np.iinfo(dt).max:
            return np.dtype(dt)
    raise OverflowError(f"value {max_value} exceeds uint64")


def _at_capacity(arr: np.ndarray, nnz_like: int) -> np.ndarray:
    """Copy into a pow-2-capacity buffer (live region [:len(arr)])."""
    cap = _bucket_capacity(nnz_like)
    out = np.zeros(cap, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _weights_narrow(w: np.ndarray) -> tuple[np.ndarray, bool]:
    """Narrowest uint storage for integer-count weights; f64 fallback
    (flagged) for anything that isn't a positive integer < 2^53 — a
    fallback is lossless, a wrap would be silent corruption, so the
    dtype is always chosen from the ACTUAL value range."""
    w = np.asarray(w, dtype=np.float64)
    if w.shape[0] == 0:
        return w.astype(np.uint8), False
    wmax = float(w.max(initial=0.0))
    integral = bool(
        (w > 0).all() and (w == np.floor(w)).all() and wmax < 2.0**53
    )
    if not integral:
        return w.copy(), True
    return w.astype(_narrow_uint_dtype(int(wmax))), False


@dataclasses.dataclass(frozen=True)
class _Chunk:
    """One ``chunk_rows``-row span of the factor, encoded.

    Entries live in chunk-local LAYOUT order: rows hub-first
    (descending count, ascending local row — re-derivable from
    ``row_counts``, so the order costs no storage), columns ascending
    in PERMUTED space within each row. ``weights``/``cols``/``bits``
    buffers are pow-2-capacity allocations; the live region is
    ``[:nnz]`` (resp. the encoded bit length).
    """

    row0: int
    n_rows: int
    nnz: int
    row_counts: np.ndarray          # uint32 [n_rows], ORIGINAL row order
    weights: np.ndarray             # layout order; narrow uint or f64
    cols: np.ndarray | None         # blocked: permuted cols, layout order
    bits: np.ndarray | None         # bitpacked: uint8 bit stream
    block_bits: np.ndarray | None   # bitpacked: uint8 width per block

    def nbytes(self) -> int:
        total = self.row_counts.nbytes + self.weights.nbytes
        if self.cols is not None:
            total += self.cols.nbytes
        if self.bits is not None:
            total += self.bits.nbytes + self.block_bits.nbytes
        return total


def _layout_order(row_counts: np.ndarray) -> np.ndarray:
    """Hub-first row layout of one chunk: local rows sorted by
    (descending count, ascending local row). Deterministic, derived —
    encode and decode can never disagree."""
    n = row_counts.shape[0]
    return np.lexsort(
        (np.arange(n), -row_counts.astype(np.int64))
    )


def _pack_bit_blocks(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack uint values into fixed-width blocks of ``_BLOCK_NNZ``:
    each block's width adapts to its own max value. Returns
    (uint8 bit stream, uint8 width-per-block)."""
    nnz = vals.shape[0]
    if nnz == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.uint8)
    vals = vals.astype(np.uint64)
    nb = -(-nnz // _BLOCK_NNZ)
    widths = np.empty(nb, dtype=np.uint8)
    pieces: list[np.ndarray] = []
    for b in range(nb):
        blk = vals[b * _BLOCK_NNZ : (b + 1) * _BLOCK_NNZ]
        w = int(_bits_needed(np.asarray([blk.max()]))[0])
        widths[b] = w
        shifts = np.arange(w - 1, -1, -1, dtype=np.uint64)
        pieces.append(
            ((blk[:, None] >> shifts[None, :]) & 1).astype(np.uint8).ravel()
        )
    stream = np.packbits(np.concatenate(pieces))
    return stream, widths


def _unpack_bit_blocks(
    stream: np.ndarray, widths: np.ndarray, nnz: int
) -> np.ndarray:
    """Inverse of :func:`_pack_bit_blocks` → uint64 [nnz]."""
    if nnz == 0:
        return np.zeros(0, dtype=np.uint64)
    sizes = np.full(widths.shape[0], _BLOCK_NNZ, dtype=np.int64)
    sizes[-1] = nnz - _BLOCK_NNZ * (widths.shape[0] - 1)
    total_bits = int((sizes * widths.astype(np.int64)).sum())
    flat = np.unpackbits(stream, count=total_bits).astype(np.uint64)
    out = np.empty(nnz, dtype=np.uint64)
    bit_at = 0
    val_at = 0
    for b in range(widths.shape[0]):
        w = int(widths[b])
        n = int(sizes[b])
        block = flat[bit_at : bit_at + n * w].reshape(n, w)
        powers = (np.uint64(1) << np.arange(
            w - 1, -1, -1, dtype=np.uint64
        ))
        out[val_at : val_at + n] = block @ powers
        bit_at += n * w
        val_at += n
    return out


def _pack_chunk(
    fmt: str,
    row0: int,
    n_rows: int,
    rows_local: np.ndarray,
    pcols: np.ndarray,
    weights: np.ndarray,
) -> _Chunk:
    """Encode one chunk from its (local row, permuted col, f64 weight)
    triples (any input order; duplicates must already be coalesced)."""
    row_counts = np.bincount(
        rows_local, minlength=n_rows
    ).astype(np.uint32)
    nnz = int(rows_local.shape[0])
    order_rows = _layout_order(row_counts)
    rank = np.empty(n_rows, dtype=np.int64)
    rank[order_rows] = np.arange(n_rows)
    order = np.lexsort((pcols, rank[rows_local]))
    pcols_l = pcols[order].astype(np.uint64)
    w_narrow, f64_fallback = _weights_narrow(weights[order])
    if f64_fallback:
        # lossless but 8 B/nnz instead of 1-2: an operator watching
        # dpathsim_factor_bytes deserves a signal explaining why
        # compression degraded, not just a bigger number
        _record_f64_fallback(fmt)
    w_cap = _at_capacity(w_narrow, nnz)
    if fmt == "blocked":
        cmax = int(pcols_l.max(initial=0))
        cols = _at_capacity(
            pcols_l.astype(_narrow_uint_dtype(cmax)), nnz
        )
        return _Chunk(
            row0=row0, n_rows=n_rows, nnz=nnz, row_counts=row_counts,
            weights=w_cap, cols=cols, bits=None, block_bits=None,
        )
    # bitpacked: delta-encode within rows (layout order): the first
    # column of a row is absolute, later ones store gap−1 (columns are
    # strictly ascending in permuted space after coalescing).
    counts_layout = row_counts[order_rows].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts_layout)])[:-1]
    first = np.zeros(nnz, dtype=bool)
    first[starts[counts_layout > 0]] = True
    vals = pcols_l.copy()
    nf = ~first
    if nf.any():
        vals[nf] = pcols_l[nf] - pcols_l[np.flatnonzero(nf) - 1] - 1
    stream, widths = _pack_bit_blocks(vals)
    return _Chunk(
        row0=row0, n_rows=n_rows, nnz=nnz, row_counts=row_counts,
        weights=w_cap, cols=None,
        bits=_at_capacity(stream, stream.shape[0]),
        block_bits=widths,
    )


def _decode_chunk(
    f: "PackedFactor", ch: _Chunk
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One chunk → (global rows int64, ORIGINAL cols int64, f64
    weights), row-major sorted with ascending original columns within
    each row — i.e. already in canonical COO order for its row span."""
    nnz = ch.nnz
    if nnz == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=np.float64)
    order_rows = _layout_order(ch.row_counts)
    counts_layout = ch.row_counts[order_rows].astype(np.int64)
    rows_layout = np.repeat(order_rows, counts_layout)
    if ch.cols is not None:
        pcols = ch.cols[:nnz].astype(np.int64)
    else:
        vals = _unpack_bit_blocks(
            ch.bits, ch.block_bits, nnz
        ).astype(np.int64)
        # Invert the per-row delta encoding with one segmented cumsum:
        # adj = head value at each row start, gap+1 elsewhere, so the
        # running sum minus the sum BEFORE the segment is exactly the
        # reconstructed permuted column.
        starts = np.concatenate([[0], np.cumsum(counts_layout)])[:-1]
        live = counts_layout > 0
        adj = vals + 1
        adj[starts[live]] = vals[starts[live]]
        csum = np.cumsum(adj)
        seg_base = np.concatenate([[0], csum])[starts[live]]
        pcols = csum - np.repeat(seg_base, counts_layout[live])
    cols = f.col_perm.invert(pcols)
    # canonical order: (local row, ORIGINAL col) ascending — the
    # layout's permuted-space order is an encoding detail and must not
    # leak into the boundary.
    order = np.lexsort((cols, rows_layout))
    rows = rows_layout[order] + ch.row0
    return (
        rows.astype(np.int64),
        cols[order].astype(np.int64),
        ch.weights[:nnz].astype(np.float64)[order],
    )


@dataclasses.dataclass(frozen=True)
class PackedFactor:
    """A compressed resident factor: chunked, permuted, narrow.

    Construct ONLY through :func:`make_factor`; read ONLY through the
    ``SANCTIONED_FACTORY`` accessors. ``colsum`` is
    the exact f64 column-total vector in ORIGINAL column space — kept
    here because every consumer needs it and recomputing it would
    force a full decode."""

    fmt: str
    shape: tuple[int, int]
    nnz: int
    chunk_rows: int
    chunks: tuple[_Chunk, ...]
    col_perm: PermutationPair
    colsum: np.ndarray
    perm_bytes: int = 0  # 0 for identity; fixed at construction
    promotions: int = 0

    def nbytes(self) -> int:
        return int(
            sum(ch.nbytes() for ch in self.chunks)
            + self.colsum.nbytes
            + self.perm_bytes
        )


def _canonical_coo(c: sp.COOMatrix) -> sp.COOMatrix:
    """Row-major sorted, coalesced, zero-free — the canonical form a
    pack/unpack round trip reproduces. Already-canonical inputs (the
    common case: ``_matmul_summed`` output) pass through untouched."""
    if is_canonical(c):
        return c
    return sp.coo_nonzero(c.summed())


def is_packed(x) -> bool:
    return isinstance(x, PackedFactor)


def is_canonical(c) -> bool:
    """True when a COO factor is already row-major sorted, coalesced,
    and zero-free — i.e. a pack/unpack round trip reproduces it
    entry-for-entry IN ORDER, not just in content. Callers that must
    hand back byte-identical arrays (the sub-chain memo) pack only
    canonical entries; packed factors are canonical by construction."""
    if is_packed(c):
        return True
    key = c.rows.astype(np.int64) * c.shape[1] + c.cols.astype(np.int64)
    return bool(
        c.rows.shape[0] == 0
        or (np.diff(key) > 0).all() and (c.weights != 0.0).all()
    )


def make_factor(
    c: sp.COOMatrix,
    fmt: str,
    chunk_rows: int | None = None,
    permute: bool = True,
):
    """The sanctioned factory: a COO factor → its resident
    representation for ``fmt``. ``"coo"`` returns the input unchanged
    (the zero-cost arm every consumer already speaks); packed formats
    canonicalize, compute the hub-first column permutation
    (data/compress.py), and encode per chunk. ``chunk_rows`` should
    match the consumer's row-tile granularity (the torch-sparse backend
    passes its tile width) so tile extraction decodes exactly the
    chunks it needs."""
    if fmt not in FACTOR_FORMATS:
        raise ValueError(
            f"unknown factor format {fmt!r}; choose from {FACTOR_FORMATS}"
        )
    if fmt == "coo":
        return c
    if is_packed(c):
        raise TypeError("make_factor takes a COO factor, not a packed one")
    cc = _canonical_coo(c)
    chunk_rows = int(chunk_rows or _PACK_CHUNK_ROWS)
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    rows = cc.rows.astype(np.int64)
    cols = cc.cols.astype(np.int64)
    w = cc.weights.astype(np.float64)
    if permute:
        # only the COLUMN marginal is needed here — the row layout
        # order is chunk-local and derived from the count tables, so
        # computing (and discarding) a full row permutation would
        # waste an O(N log N) sort and N-sized transients per pack
        col_pair = PermutationPair.from_perm(
            degree_order(np.bincount(cols, minlength=int(cc.shape[1])))
        )
    else:
        col_pair = PermutationPair.identity(cc.shape[1])
    if cc.shape[1] < np.iinfo(np.int32).max:
        # the stored permutation is part of the resident footprint
        # (nbytes counts it honestly) — at wide V (APA: V = #papers)
        # int32 halves that cost
        col_pair = PermutationPair(
            perm=col_pair.perm.astype(np.int32),
            inv=col_pair.inv.astype(np.int32),
        )
    pcols_all = col_pair.apply(cols)
    n_chunks = max(1, -(-cc.shape[0] // chunk_rows))
    bounds = np.arange(n_chunks + 1) * chunk_rows
    starts = np.searchsorted(rows, bounds[:-1], side="left")
    stops = np.searchsorted(rows, bounds[1:], side="left")
    chunks = []
    for i in range(n_chunks):
        r0 = i * chunk_rows
        nr = min(chunk_rows, cc.shape[0] - r0)
        s, e = int(starts[i]), int(stops[i])
        chunks.append(_pack_chunk(
            fmt, r0, nr, rows[s:e] - r0, pcols_all[s:e], w[s:e],
        ))
    colsum = np.zeros(cc.shape[1], dtype=np.float64)
    if rows.shape[0]:
        np.add.at(colsum, cols, w)
    return PackedFactor(
        fmt=fmt, shape=cc.shape, nnz=int(rows.shape[0]),
        chunk_rows=chunk_rows, chunks=tuple(chunks), col_perm=col_pair,
        colsum=colsum,
        perm_bytes=(
            0 if not permute
            else int(col_pair.perm.nbytes + col_pair.inv.nbytes)
        ),
    )


def as_coo(f) -> sp.COOMatrix:
    """Packed → canonical COO (row-major sorted, coalesced, zero-free,
    ORIGINAL ids) — the host-boundary inverse of :func:`make_factor`.
    COO inputs pass through (so consumers can hold either)."""
    if not is_packed(f):
        return f
    parts = [_decode_chunk(f, ch) for ch in f.chunks if ch.nnz]
    if not parts:
        z = np.zeros(0, dtype=np.int64)
        return sp.COOMatrix(
            rows=z, cols=z.copy(),
            weights=np.zeros(0, dtype=np.float64), shape=f.shape,
        )
    return sp.COOMatrix(
        rows=np.concatenate([p[0] for p in parts]),
        cols=np.concatenate([p[1] for p in parts]),
        weights=np.concatenate([p[2] for p in parts]),
        shape=f.shape,
    )


def row_slice(f: PackedFactor, r0: int, r1: int) -> sp.COOMatrix:
    """Entries with row in ``[r0, r1)`` as canonical COO (global row
    ids, original cols) — decodes ONLY the chunks the span touches,
    which is the O(span-nnz) contract the tile extraction and the
    partition windows rely on."""
    r0, r1 = int(r0), int(r1)
    lo = max(0, r0 // f.chunk_rows)
    hi = min(len(f.chunks), -(-r1 // f.chunk_rows))
    rows_l, cols_l, w_l = [], [], []
    for ch in f.chunks[lo:hi]:
        if ch.nnz == 0:
            continue
        rows, cols, w = _decode_chunk(f, ch)
        if r0 > ch.row0 or r1 < ch.row0 + ch.n_rows:
            keep = (rows >= r0) & (rows < r1)
            rows, cols, w = rows[keep], cols[keep], w[keep]
        rows_l.append(rows)
        cols_l.append(cols)
        w_l.append(w)
    if not rows_l:
        z = np.zeros(0, dtype=np.int64)
        return sp.COOMatrix(
            rows=z, cols=z.copy(),
            weights=np.zeros(0, dtype=np.float64), shape=f.shape,
        )
    return sp.COOMatrix(
        rows=np.concatenate(rows_l), cols=np.concatenate(cols_l),
        weights=np.concatenate(w_l), shape=f.shape,
    )


def row_range_nnz(f: PackedFactor, r0: int, r1: int) -> int:
    """Exact nnz of rows ``[r0, r1)`` — O(span rows) from the per-row
    count tables, no decode."""
    r0, r1 = max(0, int(r0)), min(int(f.shape[0]), int(r1))
    total = 0
    lo = r0 // f.chunk_rows
    hi = -(-r1 // f.chunk_rows)
    for ch in f.chunks[lo:hi]:
        a = max(r0 - ch.row0, 0)
        b = min(r1 - ch.row0, ch.n_rows)
        if b > a:
            total += int(ch.row_counts[a:b].sum())
    return total


def gather_rows_dense(
    f: PackedFactor, rows, dtype=np.float64
) -> np.ndarray:
    """Dense [len(rows), V] gather of arbitrary factor rows in
    ORIGINAL column space — the packed analog of the rescore path's
    CSR gather. Each touched chunk decodes once per call."""
    rows = np.asarray(rows, dtype=np.int64)
    out = np.zeros((rows.shape[0], f.shape[1]), dtype=dtype)
    if rows.shape[0] == 0:
        return out
    chunk_of = rows // f.chunk_rows
    for ci in np.unique(chunk_of):
        ch = f.chunks[int(ci)]
        if ch.nnz == 0:
            continue
        crows, ccols, cw = _decode_chunk(f, ch)
        sel = np.flatnonzero(chunk_of == ci)
        # positions of each requested row's entries inside the chunk
        order = np.argsort(crows, kind="stable")
        crows_s = crows[order]
        starts = np.searchsorted(crows_s, rows[sel], side="left")
        stops = np.searchsorted(crows_s, rows[sel], side="right")
        counts = stops - starts
        total = int(counts.sum())
        if total == 0:
            continue
        ridx = np.repeat(sel, counts)
        cum = np.concatenate([[0], np.cumsum(counts)])
        flat = np.repeat(starts, counts) + (
            np.arange(total) - np.repeat(cum[:-1], counts)
        )
        out[ridx, ccols[order][flat]] = cw[order][flat]
    return out


def factor_colsum(f) -> np.ndarray:
    """Exact f64 column totals in ORIGINAL column space."""
    if is_packed(f):
        return f.colsum
    colsum = np.zeros(f.shape[1], dtype=np.float64)
    if f.rows.shape[0]:
        np.add.at(colsum, f.cols, f.weights)
    return colsum


def factor_rowsums_weighted(f, colvec: np.ndarray) -> np.ndarray:
    """``rs[i] = Σ_j w_ij · colvec[col_ij]`` in exact f64 (integer
    inputs < 2^53) — the host rowsum/denominator path, chunk-streamed
    so the transient never exceeds one chunk."""
    colvec = np.asarray(colvec, dtype=np.float64)
    if not is_packed(f):
        rs = np.zeros(f.shape[0], dtype=np.float64)
        if f.rows.shape[0]:
            np.add.at(rs, f.rows, f.weights * colvec[f.cols])
        return rs
    rs = np.zeros(f.shape[0], dtype=np.float64)
    for ch in f.chunks:
        if ch.nnz == 0:
            continue
        rows, cols, w = _decode_chunk(f, ch)
        np.add.at(rs, rows, w * colvec[cols])
    return rs


def factor_diag(f) -> np.ndarray:
    """``diag[i] = Σ_j w_ij²`` (the textbook-PathSim denominator),
    chunk-streamed."""
    if not is_packed(f):
        s = f.summed()
        d = np.zeros(f.shape[0], dtype=np.float64)
        if s.rows.shape[0]:
            np.add.at(d, s.rows, s.weights**2)
        return d
    d = np.zeros(f.shape[0], dtype=np.float64)
    for ch in f.chunks:
        if ch.nnz == 0:
            continue
        rows, _, w = _decode_chunk(f, ch)
        np.add.at(d, rows, w**2)
    return d


def factor_bytes(f) -> int:
    """Resident bytes of the factor as held (capacity buckets
    included — this is the honest number the bench and the
    ``dpathsim_factor_bytes`` gauge report)."""
    if is_packed(f):
        return f.nbytes()
    return int(f.rows.nbytes + f.cols.nbytes + f.weights.nbytes)


def factor_nnz(f) -> int:
    return int(f.nnz if is_packed(f) else f.rows.shape[0])


def content_digest(f) -> str:
    """sha256[:16] over the CANONICAL coalesced content (sorted rows/
    cols int64 + weights f64) — format-independent: a packed factor
    and its COO equivalent digest identically, so checkpoint/cache
    identity survives a format flip. Memoized per factor object."""
    if is_packed(f):
        cache = f.__dict__.get("_digest_cache")
        if cache is not None:
            return cache
        # One transient decode: the hash must consume all-rows, then
        # all-cols, then all-weights (the COO path's byte stream) so a
        # packed factor and its COO twin digest identically.
        digest = content_digest(as_coo(f))
        object.__setattr__(f, "_digest_cache", digest)
        return digest
    cc = _canonical_coo(f)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(cc.rows, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(cc.cols, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(cc.weights, dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


def _record_f64_fallback(fmt: str) -> None:
    from ..obs.metrics import get_registry

    get_registry().counter(
        "dpathsim_packed_f64_fallback_total",
        "packed chunks stored with f64 weights (non-integer data — "
        "lossless, but the narrow-count compression did not apply)",
    ).inc(format=fmt)


def _record_promotion(fmt: str) -> None:
    from ..obs.metrics import get_registry

    get_registry().counter(
        "dpathsim_packed_promotions_total",
        "packed-chunk weight dtype widenings (loud, never a wrap)",
    ).inc(format=fmt)


def patch_factor(f: PackedFactor, delta_c: sp.COOMatrix) -> PackedFactor:
    """Apply a signed half-chain delta (ΔC from the delta product
    rule) to a packed factor, re-encoding ONLY the chunks whose rows
    the delta touches — the packed analog of
    :func:`~.sparse.coo_apply_delta`, same row-granular O(Δ +
    touched-chunk-nnz) contract, bit-identical result content. A
    patched chunk whose counts outgrow their narrow dtype is
    re-encoded wider (counted on ``promotions`` and the
    ``dpathsim_packed_promotions_total`` metric) — promotion is loud,
    wrap-around is impossible because dtypes are always re-chosen from
    the actual post-patch values."""
    if not is_packed(f):
        raise TypeError("patch_factor patches packed factors only")
    if delta_c.rows.shape[0] == 0:
        return f
    if tuple(delta_c.shape) != tuple(f.shape):
        raise ValueError(
            f"delta shape {delta_c.shape} != factor {f.shape}"
        )
    dc = _canonical_coo(delta_c)
    drows = dc.rows.astype(np.int64)
    touched = np.unique(drows // f.chunk_rows)
    chunks = list(f.chunks)
    promotions = f.promotions
    for ci in touched:
        ch = chunks[int(ci)]
        crows, ccols, cw = _decode_chunk(f, ch)
        span = sp.COOMatrix(
            rows=crows, cols=ccols, weights=cw, shape=f.shape
        )
        mask = drows // f.chunk_rows == ci
        sub = sp.COOMatrix(
            rows=drows[mask], cols=dc.cols[mask],
            weights=dc.weights[mask], shape=f.shape,
        )
        patched = sp.coo_apply_delta(span, sub)
        patched = sp.coo_nonzero(patched.summed())
        keep = (
            (patched.rows >= ch.row0)
            & (patched.rows < ch.row0 + ch.n_rows)
        )
        new_chunk = _pack_chunk(
            f.fmt, ch.row0, ch.n_rows,
            patched.rows[keep].astype(np.int64) - ch.row0,
            f.col_perm.apply(patched.cols[keep]),
            patched.weights[keep].astype(np.float64),
        )
        if new_chunk.weights.dtype.itemsize > ch.weights.dtype.itemsize:
            promotions += 1
            _record_promotion(f.fmt)
        chunks[int(ci)] = new_chunk
    # Integer counts (< 2^53, the uint chunk invariant) make f64
    # addition order-exact, so the O(Δ) incremental colsum equals a
    # from-scratch accumulation bit-for-bit. Non-integer data (the f64
    # fallback) has no such order-independence — recompute chunk-wise
    # from the patched entries so the patched factor's colsum always
    # equals what a fresh pack of the same content would carry.
    int_exact = bool(
        (dc.weights == np.floor(dc.weights)).all()
        and all(ch.weights.dtype.kind == "u" for ch in chunks)
    )
    if int_exact:
        dcolsum = np.zeros(f.shape[1], dtype=np.float64)
        np.add.at(dcolsum, dc.cols, dc.weights.astype(np.float64))
        colsum = f.colsum + dcolsum
    else:
        colsum = np.zeros(f.shape[1], dtype=np.float64)
        for ch in chunks:
            if ch.nnz:
                _, ccols, cw = _decode_chunk(f, ch)
                np.add.at(colsum, ccols, cw)
    return PackedFactor(
        fmt=f.fmt, shape=f.shape,
        nnz=int(sum(ch.nnz for ch in chunks)),
        chunk_rows=f.chunk_rows, chunks=tuple(chunks),
        col_perm=f.col_perm, colsum=colsum,
        perm_bytes=f.perm_bytes, promotions=promotions,
    )


def packed_matmul(a, b) -> sp.COOMatrix:
    """Exact COO product of two factors in any representation — the
    same host join (and therefore the same exact integers, row-major
    sorted) as ``ops.sparse._matmul_summed`` on the COO path."""
    return sp.matmul_summed(as_coo(a), as_coo(b))


def fold_half(
    hin, metapath, fmt: str, memo=None, chunk_rows: int | None = None,
):
    """Plan-ordered half-chain fold → resident factor in ``fmt`` —
    the packed twin of ``planner.fold_half`` (which it delegates to,
    so the fold itself stays behind the planner doorway / MP001)."""
    from . import planner

    coo = planner.fold_half(hin, metapath, memo=memo)
    return make_factor(coo, fmt, chunk_rows=chunk_rows)
