"""Routing policies: which replica owns a row, and who comes next.

Both policies answer the same question — a *preference order* over the
live workers for a given routing key — because the router needs more
than an owner: failover re-dispatch, hedged sends, and fencing all walk
the same order looking for the next eligible replica, and that order
must be deterministic (a chaos run's reroute decisions reproduce
exactly).

- :class:`HashRing` — consistent hashing with virtual nodes. Cache
  affinity is the point: the same row always lands on the same replica
  (its tier-1/tier-2 entries stay hot there), and when a replica dies
  only ~1/N of the keyspace moves instead of everything reshuffling
  (the classic Karger construction). The points are the JAX
  package's, so both packages give one key the same preference list.
- :class:`RangeRouter` — contiguous row ranges. The fallback geometry
  for workloads with strong row locality (range scans, bulk rankings)
  where hashing would scatter a hot band over every replica; also the
  natural shape for a bigger-than-one-host graph split, where a worker
  *holds* only its range (partition mode, router/partition.py).

Hashes are sha256 over stable strings — never Python ``hash()``, whose
per-process randomization would route the same row differently on every
restart and silently destroy affinity.
"""

from __future__ import annotations

import bisect
import hashlib

from ..data.partition import PartitionMap


def _h64(s: str) -> int:
    """Stable 64-bit point on the ring for a key string."""
    return int.from_bytes(
        hashlib.sha256(s.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Consistent-hash preference order over worker ids.

    ``vnodes`` virtual points per worker smooth the keyspace split (a
    plain one-point-per-worker ring can give one worker 3× the load of
    another at small N). ``preference(key)`` walks the ring clockwise
    from the key's point and returns each distinct worker in encounter
    order — position 0 is the owner (affinity target), the rest are the
    failover/hedge order.
    """

    def __init__(self, worker_ids: list[str], vnodes: int = 64):
        if not worker_ids:
            raise ValueError("hash ring needs at least one worker")
        self.vnodes = int(vnodes)
        self._workers = sorted(worker_ids)  # order-independent ring
        self._points: list[int] = []
        self._owner_at: dict[int, str] = {}
        for wid in self._workers:
            for v in range(self.vnodes):
                pt = _h64(f"{wid}#{v}")
                # collisions across 64-bit points are ~impossible; if
                # one happens the sorted-worker order makes it stable
                if pt not in self._owner_at:
                    self._owner_at[pt] = wid
                    self._points.append(pt)
        self._points.sort()

    @property
    def workers(self) -> tuple[str, ...]:
        return tuple(self._workers)

    def preference(self, key: int | str) -> tuple[str, ...]:
        """All workers, owner first, in deterministic ring order."""
        pt = _h64(f"row:{key}")
        i = bisect.bisect_right(self._points, pt)
        seen: list[str] = []
        for off in range(len(self._points)):
            wid = self._owner_at[self._points[(i + off) % len(self._points)]]
            if wid not in seen:
                seen.append(wid)
                if len(seen) == len(self._workers):
                    break
        return tuple(seen)

    def owner(self, key: int | str) -> str:
        return self.preference(key)[0]

    def owner_of(self, row: int | str) -> str:
        """Alias of :meth:`owner` — the stable ownership API both
        policies export (range mode adds :meth:`range_of`)."""
        return self.owner(row)

    def without(self, worker_id: str) -> "HashRing":
        """The ring minus one member (worker death): every key that
        worker owned moves to its ring successor; every other key keeps
        its owner — the minimal-disruption property tests assert."""
        rest = [w for w in self._workers if w != worker_id]
        return HashRing(rest, vnodes=self.vnodes)


class RangeRouter:
    """Contiguous row-range ownership over ``n_rows``.

    Worker ``i`` of W owns rows ``[i*ceil(n/W), (i+1)*ceil(n/W))`` —
    the ceil-division geometry shared with
    :class:`~..data.partition.PartitionMap`, so routing and *ownership*
    (partition mode, where a worker only HOLDS its ranges) can never
    disagree. Preference order is owner, then neighbors outward (the
    replicas most likely to have adjacent rows warm). Non-integer keys
    (label queries) fall back to a stable hash into the row space, so
    the interface stays total.

    The stable ownership API — :meth:`owner_of` (row → worker id,
    strict on the row domain) and :meth:`range_of` (worker id →
    half-open row range) — is what a partitioned fleet builds on.
    """

    def __init__(self, worker_ids: list[str], n_rows: int):
        if not worker_ids:
            raise ValueError("range router needs at least one worker")
        self._workers = sorted(worker_ids)
        self.n_rows = max(int(n_rows), 1)
        self._pmap = PartitionMap(n=self.n_rows, p=len(self._workers))
        self._span = self._pmap.span

    @property
    def workers(self) -> tuple[str, ...]:
        return tuple(self._workers)

    def preference(self, key: int | str) -> tuple[str, ...]:
        if not isinstance(key, int):
            key = _h64(f"label:{key}") % self.n_rows
        w = len(self._workers)
        i = min(max(int(key), 0) // self._span, w - 1)
        order = [i]
        for off in range(1, w):
            if i + off < w:
                order.append(i + off)
            if i - off >= 0:
                order.append(i - off)
        return tuple(self._workers[j] for j in order[:w])

    def owner(self, key: int | str) -> str:
        return self.preference(key)[0]

    def owner_of(self, row: int) -> str:
        """Worker id owning ``row`` — strict on ``[0, n_rows)`` (an
        out-of-range row is a caller bug, not a routing choice; the
        forgiving clamp lives in :meth:`preference` for label keys)."""
        return self._workers[self._pmap.owner_of(int(row))]

    def range_of(self, worker_id: str) -> tuple[int, int]:
        """Half-open row range ``[lo, hi)`` this worker owns. The last
        worker absorbs the ceil-division remainder; with a single
        worker the range is the whole row space."""
        try:
            i = self._workers.index(worker_id)
        except ValueError:
            raise KeyError(
                f"unknown worker {worker_id!r} "
                f"(members: {self._workers})"
            ) from None
        return self._pmap.range_of(i)

    def without(self, worker_id: str) -> "RangeRouter":
        rest = [w for w in self._workers if w != worker_id]
        return RangeRouter(rest, n_rows=self.n_rows)


def make_policy(
    routing: str, worker_ids: list[str], n_rows: int, vnodes: int = 64
):
    """``--routing`` flag → policy instance."""
    if routing == "hash":
        return HashRing(worker_ids, vnodes=vnodes)
    if routing == "range":
        return RangeRouter(worker_ids, n_rows=n_rows)
    raise ValueError(f"unknown routing policy {routing!r} (hash|range)")
