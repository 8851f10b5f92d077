"""Centroid-quantized MIPS index with padded, shape-stable cluster blocks.

Layout: k-means assigns every node to one of K centroids, but instead
of the classic IVF ragged posting lists (whose traversal is a
gather-per-list scan), every cluster's member embeddings are packed
into one ``[K, cap, D]`` tensor padded to a common ``cluster_cap``. A
probe for a batch of B query rows is then:

1. ``[B, D] @ [D, K]``       — centroid similarities, pick top nprobe;
2. gather the nprobe blocks  — ``[B, nprobe·cap, D]``, one fancy index;
3. ``einsum('bd,bcd->bc')``  — ONE batched matmul over the packed rows.

The probe runs as torch ops on the index's ``device`` (CUDA unless the
caller asks for the CPU), every shape fixed by (bucket, nprobe, cap),
in true f32 (never TF32: it would shift near-tied similarities and
change which clusters are probed). The top-nprobe clusters are picked
by a stable descending sort, so equal similarities keep the lowest
centroid id first — the JAX package's ``lax.top_k`` order; never
``torch.topk``, whose tie order CUDA does not promise. Candidate
*selection* (top-C of the probed similarities) runs on the host, which
keeps the device work independent of k.

Capacity-bounded packing: clusters larger than ``cluster_cap`` spill
their farthest members to the next-nearest centroid with space. Pad
slots carry member id −1 and a zero vector; the probe masks them to
−inf before selection, so they can never surface.

Staleness: a delta update marks its affected rows stale
(:meth:`mark_stale`); stale rows are the serving layer's exact-fallback
set until :meth:`refresh_rows` re-embeds them in place (same slot when
the centroid assignment still holds, moved when a better centroid has
space). The index carries the ``(base_fp, delta_seq)`` consistency
token it was built/refreshed at, so router replicas can agree on index
epochs the same way they agree on graph epochs.

The host arrays, their dtypes and the ``.npz`` artifact are the JAX
package's ``index/mips.py`` byte for byte: an artifact either package
writes loads in the other. The batch tier's ``simjoin --grouping
centroid`` reuses :func:`balanced_kmeans`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

_SCHEMA_VERSION = 1


class IndexMismatch(ValueError):
    """A persisted index does not match the graph/config it is asked to
    serve (base fingerprint, variant, metapath, or schema version)."""


def _cap_round(x: int) -> int:
    """Cluster caps round up to a multiple of 8 — NOT to a power of two:
    the probe only needs the cap fixed, and pow-2 rounding near-doubles
    pad slots at typical √N cluster sizes (every pad slot is wasted
    probe/rerank traffic)."""
    return max(8, -(-int(x) // 8) * 8)


def balanced_kmeans(
    emb: np.ndarray, k: int, cap: int, iters: int = 10, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Capacity-constrained Lloyd iterations: every round runs a
    capacity-bounded assignment (closest nodes win the seats; overflow
    spills down each node's centroid-preference list) and recomputes
    centroids from the members a cluster ACTUALLY holds. Plain k-means
    + post-hoc capping failed measurably here: skewed-norm embedding
    corpora collapse into one mega-cluster whose capped overflow lands
    far from any centroid that describes it, and probe routing (top
    nprobe by query·centroid) then misses true top-k targets outright
    (recall@10 0.88 → 0.96 at nprobe=8, → 1.00 at 16, on the
    2048-author gate graph). Returns (centroids [K, D], assign [N])."""
    emb = np.asarray(emb, dtype=np.float32)
    n = emb.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centroids = emb[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(max(iters, 1)):
        assign = _balanced_assign(emb, centroids, cap)
        for kk in range(k):
            m = assign == kk
            if m.any():
                centroids[kk] = emb[m].mean(axis=0)
    return centroids, assign


def _balanced_assign(
    emb: np.ndarray, centroids: np.ndarray, cap: int, width: int = 8
) -> np.ndarray:
    """One capacity-bounded assignment pass: nodes claim seats in
    order of distance to their preferred centroid (closest first), each
    taking its best centroid with space; preference-list exhaustion
    falls back to any open cluster. K·cap ≥ N is the caller's
    feasibility contract."""
    n, k = emb.shape[0], centroids.shape[0]
    prefs = _pref_lists(emb, centroids, width=min(width, k))
    c2 = (centroids * centroids).sum(axis=1)
    d0 = c2[prefs[:, 0]] - 2.0 * np.einsum(
        "nd,nd->n", emb, centroids[prefs[:, 0]]
    )
    assign = np.full(n, -1, dtype=np.int64)
    fill = np.zeros(k, dtype=np.int64)
    for node in np.argsort(d0, kind="stable"):
        for r in range(prefs.shape[1]):
            c = prefs[node, r]
            if fill[c] < cap:
                assign[node] = c
                fill[c] += 1
                break
    unplaced = np.flatnonzero(assign < 0)
    if unplaced.size:
        open_c = np.flatnonzero(fill < cap)
        oi = 0
        for node in unplaced:
            while fill[open_c[oi]] >= cap:
                oi += 1
            assign[node] = open_c[oi]
            fill[open_c[oi]] += 1
    return assign


def _nearest(block: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """argmin_k ||x - c_k||² per row, via the matmul form (the ||x||²
    term is constant per row and drops out of the argmin)."""
    d2 = (centroids * centroids).sum(axis=1)[None, :] - 2.0 * (
        block @ centroids.T
    )
    return np.argmin(d2, axis=1)


def _pref_lists(
    emb: np.ndarray, centroids: np.ndarray, width: int, chunk: int = 16384
) -> np.ndarray:
    """Each node's ``width`` nearest centroids, nearest first."""
    n, k = emb.shape[0], centroids.shape[0]
    width = min(width, k)
    prefs = np.empty((n, width), dtype=np.int64)
    c2 = (centroids * centroids).sum(axis=1)[None, :]
    for lo in range(0, n, chunk):
        block = emb[lo:lo + chunk]
        d2 = c2 - 2.0 * (block @ centroids.T)
        part = np.argpartition(d2, width - 1, axis=1)[:, :width]
        order = np.take_along_axis(d2, part, axis=1).argsort(axis=1)
        prefs[lo:lo + chunk] = np.take_along_axis(part, order, axis=1)
    return prefs


def _top_clusters(csims: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The ``nprobe`` most similar centroids per row, most similar first,
    equal similarities in ascending centroid id (a stable descending
    sort: the order of the JAX package's ``lax.top_k``)."""
    order = torch.sort(csims, dim=1, descending=True, stable=True).indices
    return order[:, :nprobe]


def _route(centroids, members, packed, cluster_of, slot_of, rows, nprobe):
    """The route-only probe (``rerank-all`` variant): centroid GEMM +
    top-nprobe + member-id gather — no embedding-block gather at all.
    The caller reranks EVERY returned member exactly against its packed
    per-cluster count blocks, so probe traffic is a [B, K] GEMM plus
    int32 ids. Returns (member ids int32 [B, nprobe·cap] with self and
    pads at −1, clusters int32 [B, nprobe])."""
    cap = members.shape[1]
    q = packed[cluster_of[rows], slot_of[rows]]
    csims = q @ centroids.T
    top_c = _top_clusters(csims, nprobe)
    mem = members[top_c].reshape(rows.shape[0], nprobe * cap)
    mem = torch.where(mem == rows[:, None], -1, mem)
    return mem, top_c.to(torch.int32)


def _probe(centroids, members, packed, cluster_of, slot_of, rows, nprobe):
    """The shortlist probe: the route, then ONE batched matmul of the
    query against every probed member's packed embedding. Returns
    (sims f32 [B, nprobe·cap] with pads and self at −inf, member ids
    int32 [B, nprobe·cap])."""
    cap = members.shape[1]
    q = packed[cluster_of[rows], slot_of[rows]]                 # [B, D]
    csims = q @ centroids.T                                      # [B, K]
    top_c = _top_clusters(csims, nprobe)                         # [B, P]
    mem = members[top_c].reshape(rows.shape[0], nprobe * cap)
    emb = packed[top_c].reshape(rows.shape[0], nprobe * cap, packed.shape[-1])
    sims = torch.einsum("bd,bcd->bc", q, emb)
    # pads and the query row itself can never be candidates
    mask = (mem < 0) | (mem == rows[:, None])
    sims = sims.masked_fill(mask, float("-inf"))
    return sims, mem


@dataclasses.dataclass
class CentroidIndex:
    """The packed index. All arrays are host-resident numpy; the probe
    lazily mirrors them to ``device`` (None: CUDA) as copies and drops
    the mirror on refresh (a refresh is rare; a probe is the hot path)."""

    centroids: np.ndarray      # f32 [K, D]
    members: np.ndarray        # int32 [K, cap]; −1 = pad
    packed: np.ndarray         # f32 [K, cap, D]; zeros at pads
    cluster_of: np.ndarray     # int32 [N]
    slot_of: np.ndarray        # int32 [N]
    token: tuple[str, int]     # (base_fp, delta_seq) at build/refresh
    meta: dict                 # embedding source, variant, metapath, …
    stale: np.ndarray = None   # bool [N]
    # where the probe runs: None means CUDA, "cpu" the host
    device: object = dataclasses.field(default=None, repr=False,
                                       compare=False)

    def __post_init__(self):
        if self.stale is None:
            self.stale = np.zeros(self.cluster_of.shape[0], dtype=bool)
        self._dev = None        # the host arrays' copies on the device
        self._streams = None    # (probe, copy) streams on a card

    # -- introspection -----------------------------------------------------

    @property
    def n(self) -> int:
        return int(self.cluster_of.shape[0])

    @property
    def n_centroids(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def cluster_cap(self) -> int:
        return int(self.members.shape[1])

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def stale_count(self) -> int:
        return int(self.stale.sum())

    def covers(self, row: int) -> bool:
        """Is ``row`` indexed and fresh? The serving eligibility check:
        anything else answers through the exact path."""
        return 0 <= row < self.n and not bool(self.stale[row])

    def torch_device(self) -> torch.device:
        """The probe's device, resolved (CUDA without a card raises)."""
        from ..utils.device import resolve_device

        return resolve_device(self.device)

    # -- build -------------------------------------------------------------

    @classmethod
    def build(
        cls,
        emb: np.ndarray,
        n_centroids: int,
        cluster_cap: int | None = None,
        token: tuple[str, int] = ("", 0),
        meta: dict | None = None,
        seed: int = 0,
        iters: int = 8,
        device=None,
    ) -> "CentroidIndex":
        """Balanced k-means + packing (host work). ``cluster_cap`` of
        None picks a multiple-of-8 cap with 1.25× slack over a
        perfectly balanced split; an explicit cap too small to hold N
        nodes in K·cap slots is raised to the feasibility floor
        (recorded in ``meta['cap_raised_from']`` so the tuner sees
        what really ran). The capacity constraint lives INSIDE the
        k-means loop (:func:`balanced_kmeans`) so the centroids the
        probe routes on describe the capped clusters that actually
        exist."""
        emb = np.asarray(emb, dtype=np.float32)
        n = emb.shape[0]
        if n == 0:
            raise ValueError("cannot index an empty corpus")
        k = max(1, min(int(n_centroids), n))
        meta = dict(meta or {})
        floor = _cap_round(-(-n // k))
        if cluster_cap is None:
            # 1.25× slack over a perfectly balanced split: spill room
            # without paying pad traffic for slots that never fill
            cap = _cap_round(max(1, (5 * -(-n // k)) // 4))
        else:
            cap = _cap_round(cluster_cap)
            if cap < floor:
                meta["cap_raised_from"] = int(cluster_cap)
                cap = floor
        centroids, assign = balanced_kmeans(
            emb, k, cap, iters=iters, seed=seed
        )
        k = centroids.shape[0]
        cluster_of = assign.astype(np.int32)
        slot_of = np.zeros(n, dtype=np.int32)
        fill = np.zeros(k, dtype=np.int64)
        for node in range(n):
            c = assign[node]
            slot_of[node] = fill[c]
            fill[c] += 1
        members = np.full((k, cap), -1, dtype=np.int32)
        packed = np.zeros((k, cap, emb.shape[1]), dtype=np.float32)
        members[cluster_of, slot_of] = np.arange(n, dtype=np.int32)
        packed[cluster_of, slot_of] = emb
        return cls(
            centroids=centroids, members=members, packed=packed,
            cluster_of=cluster_of, slot_of=slot_of,
            token=tuple(token), meta=meta, device=device,
        )

    # -- probe -------------------------------------------------------------

    def embedding_of(self, rows: np.ndarray) -> np.ndarray:
        """Indexed rows' embeddings, read back out of the packed blocks
        (the only copy kept — queries probe with their own stored
        vector, which is what makes the index self-contained)."""
        rows = np.asarray(rows, dtype=np.int64)
        return self.packed[self.cluster_of[rows], self.slot_of[rows]]

    def _device_arrays(self):
        """The probe's operands on the device: COPIES of the host arrays
        (``torch.tensor`` never aliases numpy memory, so a refresh
        mutating the host blocks can never reach a probe in flight);
        the index arrays as int64 for gathers, ``members`` int32 as the
        probe's output dtype."""
        if self._dev is None:
            device = self.torch_device()
            if device.type == "cuda":
                from ..ops import cuda_kernels

                cuda_kernels.check_true_f32()
            self._dev = (
                torch.tensor(self.centroids, device=device),
                torch.tensor(self.members, device=device),
                torch.tensor(self.packed, device=device),
                torch.tensor(self.cluster_of, dtype=torch.int64,
                             device=device),
                torch.tensor(self.slot_of, dtype=torch.int64, device=device),
            )
        return self._dev

    def _run_device(self, fn, rows: np.ndarray, nprobe: int):
        rows = np.asarray(rows, dtype=np.int64)
        nprobe = max(1, min(int(nprobe), self.n_centroids))
        dev = self._device_arrays()
        r = torch.as_tensor(rows).to(dev[0].device)
        return fn(*dev, r, nprobe)

    def route_batch_device(self, rows: np.ndarray, nprobe: int):
        """Queue a route-only probe on the caller's current stream;
        returns un-fetched device tensors ``(member ids int32 [B,
        nprobe·cap], clusters int32 [B, nprobe])`` with self/pads
        already −1."""
        return self._run_device(_route, rows, nprobe)

    def probe_batch_device(self, rows: np.ndarray, nprobe: int):
        """Queue a shortlist probe on the caller's current stream;
        returns un-fetched device tensors ``(sims, mem)``."""
        return self._run_device(_probe, rows, nprobe)

    def _pending(self, issue, rows: np.ndarray, nprobe: int):
        """Run ``issue`` so its outputs can be fetched from ANY thread:
        on a card the work goes on the index's probe stream (after what
        the caller's stream queued), an event marks its end, and each
        output is a :class:`~..backends.torch_dense.PendingRows` whose
        ``np.asarray`` waits for that event on a copy stream before the
        pinned copy (a bare ``.cpu()`` on another thread's stream would
        not wait for the probe). On the CPU the outputs are computed."""
        device = self.torch_device()
        if device.type != "cuda":
            return issue(rows, nprobe)
        from ..backends.torch_dense import PendingRows

        if self._streams is None:
            self._streams = (torch.cuda.Stream(device),
                             torch.cuda.Stream(device))
        probe_stream, copy_stream = self._streams
        probe_stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(probe_stream):
            outs = issue(rows, nprobe)
            event = torch.cuda.Event()
            event.record(probe_stream)
        return tuple(PendingRows(o, event, copy_stream) for o in outs)

    def route_batch_pending(self, rows: np.ndarray, nprobe: int):
        """:meth:`route_batch_device` as fetchable handles (the serving
        lane's issue half)."""
        return self._pending(self.route_batch_device, rows, nprobe)

    def probe_batch_pending(self, rows: np.ndarray, nprobe: int):
        """:meth:`probe_batch_device` as fetchable handles."""
        return self._pending(self.probe_batch_device, rows, nprobe)

    def route_batch(
        self, rows: np.ndarray, nprobe: int
    ) -> tuple[np.ndarray, np.ndarray]:
        mem, top_c = self.route_batch_pending(rows, nprobe)
        return np.asarray(mem), np.asarray(top_c)

    def route_batch_host(
        self, rows: np.ndarray, nprobe: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pure-numpy routing (same candidates as the device route; the
        probed-cluster ORDER may differ — it is a set, the rerank is
        order-free). The route's work is tiny ([B, K] matvec + id
        gather), so serving routes on the host when the index's device
        is the CPU, and on the device on a card."""
        rows = np.asarray(rows, dtype=np.int64)
        nprobe = max(1, min(int(nprobe), self.n_centroids))
        q = self.packed[self.cluster_of[rows], self.slot_of[rows]]
        csims = q @ self.centroids.T
        if nprobe < self.n_centroids:
            top_c = np.argpartition(
                -csims, nprobe - 1, axis=1
            )[:, :nprobe]
        else:
            top_c = np.broadcast_to(
                np.arange(self.n_centroids), csims.shape
            )[:, :nprobe].copy()
        mem = self.members[top_c].reshape(rows.shape[0], -1)
        mem = np.where(mem == rows[:, None], -1, mem)
        return mem, top_c.astype(np.int32)

    def warm(self, buckets: Sequence[int], nprobe: int,
             variant: str = "shortlist") -> None:
        """Drive the probe once for every serving bucket (device
        buffers allocated, library GEMM configurations chosen), so the
        first real request of each bucket pays none of that."""
        for b in buckets:
            rows = np.zeros(int(b), dtype=np.int64)
            if variant == "rerank-all":
                self.route_batch(rows, nprobe)
            else:
                self.probe_batch(rows, nprobe)

    def probe_batch(
        self, rows: np.ndarray, nprobe: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Probe for a padded batch of query rows. Returns host
        ``(sims f32 [B, nprobe·cap], member ids int32 [B, nprobe·cap])``
        with pads/self at −inf; the caller selects its top-C on host so
        the device work never depends on k."""
        sims, mem = self.probe_batch_pending(rows, nprobe)
        return np.asarray(sims), np.asarray(mem)

    @staticmethod
    def select_candidates(
        sims_row: np.ndarray, mem_row: np.ndarray, n_cand: int
    ) -> np.ndarray:
        """Host top-C over one probed row: int64 candidate ids (masked
        slots dropped; may return fewer than ``n_cand``)."""
        n_cand = min(int(n_cand), sims_row.shape[0])
        part = np.argpartition(-sims_row, n_cand - 1)[:n_cand]
        keep = np.isfinite(sims_row[part])
        return mem_row[part[keep]].astype(np.int64)

    # -- staleness & refresh ----------------------------------------------

    def mark_stale(self, rows: Sequence[int] | np.ndarray) -> int:
        """Mark rows whose graph state changed: they fall back to the
        exact path until refreshed. Rows beyond the indexed range
        (appended nodes) are implicitly stale — ``covers`` is False for
        them already. Returns how many indexed rows were marked."""
        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[(rows >= 0) & (rows < self.n)]
        self.stale[rows] = True
        return int(rows.shape[0])

    def refresh_rows(
        self, rows: np.ndarray, emb: np.ndarray,
        token: tuple[str, int] | None = None,
    ) -> list[int]:
        """Re-embed ``rows`` in place with their fresh vectors, clear
        their staleness, and (optionally) advance the consistency
        token. A row whose nearest centroid changed moves when the
        target block has space; when it doesn't, the vector is updated
        in its current slot (assignment slightly off-centroid — recall
        is guarded by the serving layer's shadow sampling, and the next
        full rebuild re-balances). Returns the rows that could NOT be
        refreshed (not indexed, e.g. appended past the build): those
        stay on the exact path until a rebuild."""
        rows = np.asarray(rows, dtype=np.int64)
        emb = np.asarray(emb, dtype=np.float32)
        from ..obs.trace import get_tracer

        span = get_tracer().child_span(
            "index.refresh_rows", n=int(rows.shape[0])
        )
        with span:
            return self._refresh_rows(rows, emb, token)

    def _refresh_rows(
        self, rows: np.ndarray, emb: np.ndarray,
        token: tuple[str, int] | None,
    ) -> list[int]:
        unplaced: list[int] = []
        for i, row in enumerate(rows):
            row = int(row)
            if not 0 <= row < self.n:
                unplaced.append(row)
                continue
            vec = emb[i]
            best = int(_nearest(vec[None, :], self.centroids)[0])
            cur = int(self.cluster_of[row])
            if best != cur:
                free = np.flatnonzero(self.members[best] < 0)
                if free.size:
                    old_slot = int(self.slot_of[row])
                    self.members[cur, old_slot] = -1
                    self.packed[cur, old_slot] = 0.0
                    slot = int(free[0])
                    self.members[best, slot] = row
                    self.cluster_of[row] = best
                    self.slot_of[row] = slot
                    cur = best
            self.packed[cur, int(self.slot_of[row])] = vec
            self.stale[row] = False
        if token is not None:
            self.token = tuple(token)
        self._dev = None  # host arrays changed: re-mirror on next probe
        return unplaced

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """One ``.npz``, written atomically (tmp + rename) like every
        other artifact in this repo."""
        payload = {
            "centroids": self.centroids,
            "members": self.members,
            "packed": self.packed,
            "cluster_of": self.cluster_of,
            "slot_of": self.slot_of,
            "stale": self.stale,
            "meta": np.frombuffer(
                json.dumps({
                    **self.meta,
                    "schema_version": _SCHEMA_VERSION,
                    "base_fp": self.token[0],
                    "delta_seq": int(self.token[1]),
                }).encode(),
                dtype=np.uint8,
            ),
        }
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)

    @classmethod
    def load(
        cls, path: str, expect_base_fp: str | None = None, device=None,
    ) -> "CentroidIndex":
        """Restore; ``expect_base_fp`` (the serving graph's base
        fingerprint) rejects an index built for a different graph with
        a NAMED error instead of silently wrong candidates."""
        with np.load(path) as z:
            meta = json.loads(z["meta"].tobytes().decode())
            if meta.get("schema_version") != _SCHEMA_VERSION:
                raise IndexMismatch(
                    f"{path!r}: index schema "
                    f"{meta.get('schema_version')!r} != "
                    f"{_SCHEMA_VERSION} — rebuild with `dpathsim-torch "
                    "index build`"
                )
            base_fp = meta.pop("base_fp", "")
            delta_seq = int(meta.pop("delta_seq", 0))
            if expect_base_fp is not None and base_fp != expect_base_fp:
                raise IndexMismatch(
                    f"{path!r} was built for graph {base_fp!r}, not "
                    f"{expect_base_fp!r} — rebuild against the served "
                    "dataset (`dpathsim-torch index build`)"
                )
            meta.pop("schema_version", None)
            return cls(
                centroids=z["centroids"],
                members=z["members"],
                packed=z["packed"],
                cluster_of=z["cluster_of"],
                slot_of=z["slot_of"],
                stale=z["stale"].astype(bool),
                token=(base_fp, delta_seq),
                meta=meta,
                device=device,
            )
