"""The serving layer's multi-tier result cache.

Atrapos (arXiv:2201.04058) measures real metapath query workloads as
dominated by repeated sub-queries; for PathSim serving the repetition
shows up at two granularities, hence two tiers in front of dispatch:

- **Tier 1 — result LRU**: finished top-k answers keyed by the full
  query identity ``(graph_fingerprint, metapath, variant, row, k)``.
  A hit is a dict lookup; nothing touches the backend.
- **Tier 2 — hot-tile score cache**: normalized f64 score ROWS, grouped
  into row tiles (the all-pairs matrix's natural reuse unit — a hot
  author's whole neighborhood tends to get queried together). A hit
  re-runs only the O(N) host top-k selection, e.g. for a different
  ``k`` than what tier 1 holds — no device dispatch. Eviction is
  tile-granular under a byte budget: hot tiles survive wholesale, cold
  tiles leave wholesale.

Both tiers key on the **graph fingerprint** (content hash of every
adjacency block), so a graph reload can never serve stale answers even
if explicit invalidation were forgotten; reload additionally clears both
tiers outright (``invalidate``) to return the memory.

Thread safety: every public method takes the tier's lock — client
threads, the coalescer's completion thread, and the reload path all
touch these concurrently.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from ..data.encode import EncodedHIN
from ..obs.metrics import get_registry


def _tier_counters(tier: str):
    """Bound obs counter cells for one cache tier — bound ONCE at cache
    construction so the per-hit cost is a single cell increment, not a
    registry lookup. Per-instance ``hits``/``misses`` attributes stay
    authoritative for ``stats()``; the registry cells are the
    process-wide aggregate Prometheus and the ``metrics`` op read."""
    reg = get_registry()
    return (
        reg.counter(
            "dpathsim_serve_cache_hits_total", "cache hits by tier"
        ).labels(tier=tier),
        reg.counter(
            "dpathsim_serve_cache_misses_total", "cache misses by tier"
        ).labels(tier=tier),
        reg.counter(
            "dpathsim_serve_cache_evictions_total", "cache evictions by tier"
        ).labels(tier=tier),
    )


def graph_fingerprint(hin: EncodedHIN) -> str:
    """Content hash of the encoded graph: every adjacency block's COO
    plus the per-type sizes. Two graphs with equal fingerprints produce
    equal scores, so the fingerprint is a sound cache key component.

    Memoized per EncodedHIN (``object.__setattr__`` on the frozen
    dataclass): re-hashing every COO block on each reload/build was an
    O(nnz) tax the serving path paid repeatedly, and delta-derived HINs
    carry a CHAINED fingerprint seeded by plan_delta
    (:func:`chain_fingerprint`) — their blocks are never hashed at all.
    """
    cached = hin.__dict__.get("_fingerprint_cache")
    if cached is not None:
        return cached
    h = hashlib.sha256()
    for t in sorted(hin.schema.node_types):
        h.update(f"{t}:{hin.type_size(t)};".encode())
    for name in sorted(hin.blocks):
        b = hin.blocks[name]
        h.update(f"{name}:{b.shape};".encode())
        h.update(np.ascontiguousarray(b.rows, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(b.cols, dtype=np.int64).tobytes())
    fp = h.hexdigest()[:16]
    object.__setattr__(hin, "_fingerprint_cache", fp)
    return fp


def chain_fingerprint(base_fp: str, delta_digest: str) -> str:
    """Fingerprint of base graph ⊕ delta: ``sha256(base ∥ delta)``.

    Sound as cache identity because a delta batch is content-addressed
    (DeltaBatch.digest hashes its arrays) and apply_delta is a pure
    function of (graph, delta) — equal chains denote equal graphs. The
    ``~`` separator keeps the 17-char chained form disjoint from the
    16-hex-char base form."""
    return (
        "~" + hashlib.sha256(f"{base_fp}|{delta_digest}".encode()).hexdigest()[:16]
    )


class ResultCache:
    """Tier 1: LRU of finished (values, indices) top-k answers."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._d: OrderedDict[tuple, tuple[np.ndarray, np.ndarray]] = (
            OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._m_hits, self._m_misses, self._m_evict = _tier_counters("result")

    def get(self, key: tuple):
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                self._m_misses.inc()
                return None
            self._d.move_to_end(key)
            self.hits += 1
            self._m_hits.inc()
            return hit

    def put(self, key: tuple, vals: np.ndarray, idxs: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = (vals, idxs)
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1
                self._m_evict.inc()

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def purge_rows(self, rows) -> int:
        """Drop every entry whose source row is in ``rows`` — the
        row-granular delta invalidation. Keys are
        ``(..., row, k)``; entries for other rows survive untouched.
        Returns how many entries were dropped. O(entries), bounded by
        the LRU capacity — far cheaper than the total flush it
        replaces (which also evicted every still-valid answer)."""
        rows = set(int(r) for r in rows)
        if not rows:
            return 0
        with self._lock:
            doomed = [key for key in self._d if int(key[-2]) in rows]
            for key in doomed:
                del self._d[key]
            return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class HotTileCache:
    """Tier 2: score rows grouped into row tiles, LRU by tile under a
    byte budget. Rows fill in lazily (a tile entry holds whichever of
    its rows have been computed); eviction drops whole tiles."""

    def __init__(self, budget_bytes: int, tile_rows: int = 64):
        self.budget_bytes = int(budget_bytes)
        self.tile_rows = max(1, int(tile_rows))
        self._lock = threading.Lock()
        # tile id → {row → f64 score row}
        self._tiles: OrderedDict[tuple, dict[int, np.ndarray]] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._m_hits, self._m_misses, self._m_evict = _tier_counters("tile")

    def _tile_key(self, epoch: tuple, row: int) -> tuple:
        return (*epoch, row // self.tile_rows)

    def get_row(self, epoch: tuple, row: int) -> np.ndarray | None:
        with self._lock:
            tile = self._tiles.get(self._tile_key(epoch, row))
            hit = None if tile is None else tile.get(row)
            if hit is None:
                self.misses += 1
                self._m_misses.inc()
                return None
            self._tiles.move_to_end(self._tile_key(epoch, row))
            self.hits += 1
            self._m_hits.inc()
            return hit

    def put_row(self, epoch: tuple, row: int, scores: np.ndarray) -> None:
        if self.budget_bytes <= 0:
            return
        with self._lock:
            key = self._tile_key(epoch, row)
            tile = self._tiles.get(key)
            if tile is None:
                tile = self._tiles[key] = {}
            if row not in tile:
                self._bytes += scores.nbytes
            tile[row] = scores
            self._tiles.move_to_end(key)
            while self._bytes > self.budget_bytes and len(self._tiles) > 1:
                _, dropped = self._tiles.popitem(last=False)
                self._bytes -= sum(v.nbytes for v in dropped.values())
                self.evictions += 1
                self._m_evict.inc()

    def clear(self) -> None:
        with self._lock:
            self._tiles.clear()
            self._bytes = 0

    def purge_rows(self, rows) -> int:
        """Drop the cached score rows in ``rows`` (delta invalidation).
        Tiles keep their surviving rows — eviction stays tile-granular,
        invalidation is row-granular. Returns rows dropped."""
        rows = set(int(r) for r in rows)
        if not rows:
            return 0
        dropped = 0
        with self._lock:
            for key in list(self._tiles):
                tile = self._tiles[key]
                doomed = [r for r in tile if r in rows]
                for r in doomed:
                    self._bytes -= tile[r].nbytes
                    del tile[r]
                dropped += len(doomed)
                if not tile:
                    del self._tiles[key]
        return dropped

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes
