"""Incremental graph-delta ingestion: O(Δ) updates to an encoded HIN.

The reference recomputes its entire join chain per query. Without this
module any change to a served graph (one new paper, one new author)
would force a full reparse, re-encode, backend rebuild and a total
cache flush. This is the other half of the serving story, the part
Atrapos (arXiv:2201.04058) identifies as decisive for real-time metapath
workloads: amortizing the commuting-matrix work across updates.

Three pieces:

- **Capacity headroom** (:func:`with_headroom`): every type's index
  space is padded to a reserved capacity and adjacency blocks are built
  at capacity shape. Node appends up to the reserve change *contents*,
  never *shapes* — so every device buffer, and the factor patched in
  place on the card, survives growth. Padded slots carry no edges; backends
  trim every host-visible result to the logical size, so padding is
  semantically invisible (verified bit-for-bit by test).

- **Deltas** (:class:`DeltaBatch` / :func:`apply_delta`): a batch of
  edge adds/removes and node appends applied to an :class:`EncodedHIN`
  in O(Δ + touched-block nnz) array surgery — no string round-trip, no
  reparse. Exactness is preserved structurally: duplicate adds and
  phantom removes are rejected (the encoded graph stays simple, so
  integer path counts stay exact).

- **Plans** (:func:`plan_delta`): the serving-facing product — the new
  HIN plus the signed half-chain delta ΔC (product rule, ops/sparse),
  the patched factor, a sound superset of the score rows the delta
  affects (row-granular cache invalidation), a chained content
  fingerprint, and a fallback verdict (headroom exhausted / Δ over
  threshold / asymmetric metapath → the caller rebuilds instead of
  patching).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from .encode import AdjacencyBlock, EncodedHIN, TypeIndex

# Edge-pair keys: (row, col) packed into one int64. Index spaces are
# int32, so a 2^32 multiplier can never collide.
_KEY_SHIFT = np.int64(1) << np.int64(32)


def _edge_keys(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    return rows.astype(np.int64) * _KEY_SHIFT + cols.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class NodeAppend:
    """Append nodes to one type's index space (appends only — dense
    index spaces are append-only by design; node removal is edge
    removal plus an orphaned index slot, exactly like the reference's
    isolated topic nodes)."""

    node_type: str
    ids: tuple[str, ...] = ()
    labels: tuple[str, ...] = ()
    count: int = 0  # id-less appends for implicit-range index spaces

    @property
    def n(self) -> int:
        return len(self.ids) if self.ids else self.count


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """Edge adds/removes for one relationship, in dense index space.
    ``add``/``remove`` are int64 [m, 2] arrays of (src, dst) pairs."""

    relationship: str
    add: np.ndarray
    remove: np.ndarray

    @property
    def n_changes(self) -> int:
        return int(self.add.shape[0] + self.remove.shape[0])


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One atomic batch of graph changes. Node appends are applied
    before edge changes, so added edges may reference appended nodes."""

    edges: tuple[EdgeDelta, ...] = ()
    nodes: tuple[NodeAppend, ...] = ()

    @property
    def n_edge_changes(self) -> int:
        return sum(e.n_changes for e in self.edges)

    @property
    def n_node_appends(self) -> int:
        return sum(a.n for a in self.nodes)

    def digest(self) -> str:
        """Content hash of the batch — the fingerprint-chaining token
        (a delta's identity, so two services applying equal deltas to
        equal graphs agree on the chained fingerprint)."""
        h = hashlib.sha256()
        for a in self.nodes:
            h.update(f"n:{a.node_type}:{a.count};".encode())
            # labels default to ids (mirroring apply_delta) — zipping
            # against an empty labels tuple would silently drop id
            # appends from the digest and collide distinct deltas
            for i, lab in zip(a.ids, a.labels or a.ids):
                h.update(f"{i}\0{lab}\0".encode())
        for e in self.edges:
            h.update(f"e:{e.relationship};".encode())
            h.update(np.ascontiguousarray(e.add, dtype=np.int64).tobytes())
            h.update(b";")
            h.update(np.ascontiguousarray(e.remove, dtype=np.int64).tobytes())
        return h.hexdigest()[:16]


def _as_pairs(pairs) -> np.ndarray:
    a = np.asarray(pairs, dtype=np.int64)
    if a.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"edge pairs must be [m, 2], got {a.shape}")
    return a


def edge_delta(relationship: str, add=(), remove=()) -> EdgeDelta:
    """Convenience constructor normalizing list-of-pairs input."""
    return EdgeDelta(
        relationship=relationship, add=_as_pairs(add), remove=_as_pairs(remove)
    )


# ---------------------------------------------------------------------------
# Headroom
# ---------------------------------------------------------------------------


def _padded_capacity(size: int, headroom: float, min_slots: int = 8) -> int:
    return size + max(min_slots, int(math.ceil(size * headroom)))


def with_headroom(
    hin: EncodedHIN, headroom: float = 0.25, min_slots: int = 8
) -> EncodedHIN:
    """Reserve append capacity: every type's padded size becomes
    ``size + max(min_slots, ceil(size·headroom))`` and every adjacency
    block is re-shaped to capacity. Contents are untouched — the padded
    slots have no edges, and every backend trims results to the logical
    size, so scores are bit-identical to the unpadded encoding."""
    indices = {
        t: dataclasses.replace(
            idx, capacity=_padded_capacity(idx.size, headroom, min_slots)
        )
        for t, idx in hin.indices.items()
    }
    return EncodedHIN(
        schema=hin.schema,
        indices=indices,
        blocks=_reshape_blocks(hin.blocks, hin.schema, indices),
        name=hin.name,
    )


def strip_headroom(hin: EncodedHIN) -> EncodedHIN:
    """Drop the capacity reserve — the result is exactly what a full
    re-encode of the same logical graph produces (the parity tests'
    comparator)."""
    indices = {
        t: dataclasses.replace(idx, capacity=None)
        for t, idx in hin.indices.items()
    }
    return EncodedHIN(
        schema=hin.schema,
        indices=indices,
        blocks=_reshape_blocks(hin.blocks, hin.schema, indices),
        name=hin.name,
    )


def _reshape_blocks(blocks, schema, indices) -> dict[str, AdjacencyBlock]:
    out = {}
    for rel, b in blocks.items():
        src, dst = schema.relations[rel]
        out[rel] = dataclasses.replace(
            b, shape=(indices[src].padded_size, indices[dst].padded_size)
        )
    return out


# ---------------------------------------------------------------------------
# Applying a delta
# ---------------------------------------------------------------------------


def _append_to_index(
    idx: TypeIndex, app: NodeAppend, grow_headroom: float
) -> tuple[TypeIndex, bool]:
    """New TypeIndex with ``app`` appended. Returns (index, grew):
    ``grew`` means the append exhausted the capacity reserve and the
    padded size had to change — the caller must treat the delta as a
    full rebuild (array shapes changed)."""
    if app.ids:
        if idx.size_override is not None:
            raise ValueError(
                f"type {idx.node_type!r} has an implicit range index; "
                "append with count=, not ids"
            )
        if len(app.labels) not in (0, len(app.ids)):
            raise ValueError("labels must be empty or match ids 1:1")
        labels = app.labels or app.ids
        dup = [i for i in app.ids if i in idx.index_of]
        if dup:
            raise ValueError(f"node id(s) already present: {dup[:3]}")
        if len(set(app.ids)) != len(app.ids):
            raise ValueError("duplicate ids within one append")
        new_ids = idx.ids + tuple(app.ids)
        new_labels = idx.labels + tuple(labels)
        new_index_of = dict(idx.index_of)
        for k, i in enumerate(app.ids):
            new_index_of[i] = idx.size + k
        new = dataclasses.replace(
            idx, ids=new_ids, labels=new_labels, index_of=new_index_of
        )
    else:
        if idx.size_override is None:
            raise ValueError(
                f"type {idx.node_type!r} has materialized ids; "
                "append with ids, not count="
            )
        new = dataclasses.replace(idx, size_override=idx.size + app.count)
    cap = idx.padded_size
    if new.size > cap:
        return (
            dataclasses.replace(
                new, capacity=_padded_capacity(new.size, grow_headroom)
            ),
            True,
        )
    return dataclasses.replace(new, capacity=idx.capacity), False


def apply_delta(
    hin: EncodedHIN, delta: DeltaBatch, grow_headroom: float = 0.25
) -> tuple[EncodedHIN, bool]:
    """Apply one delta batch → (new EncodedHIN, capacity_grew).

    Node appends land first (added edges may reference them). Edge adds
    must be new and edge removes must exist — the encoding is a simple
    graph (gexf.py dedup) and exact integer path counts depend on it, so
    a malformed delta is rejected loudly rather than silently coalesced.

    ``capacity_grew=True`` means some index space outgrew its reserve:
    the new HIN is still correct (re-padded with ``grow_headroom``), but
    its array shapes changed, so warm backends cannot patch in place —
    callers fall back to a full rebuild.
    """
    indices = dict(hin.indices)
    grew = False
    for app in delta.nodes:
        if app.node_type not in indices:
            raise ValueError(f"unknown node type {app.node_type!r}")
        if app.n == 0:
            continue
        indices[app.node_type], g = _append_to_index(
            indices[app.node_type], app, grow_headroom
        )
        grew = grew or g

    deltas_by_rel: dict[str, EdgeDelta] = {}
    for e in delta.edges:
        if e.relationship not in hin.blocks:
            raise ValueError(f"unknown relationship {e.relationship!r}")
        if e.relationship in deltas_by_rel:
            raise ValueError(
                f"relationship {e.relationship!r} appears twice in one batch"
            )
        deltas_by_rel[e.relationship] = e

    blocks: dict[str, AdjacencyBlock] = {}
    for rel, b in hin.blocks.items():
        src_t, dst_t = hin.schema.relations[rel]
        shape = (indices[src_t].padded_size, indices[dst_t].padded_size)
        e = deltas_by_rel.get(rel)
        if e is None or e.n_changes == 0:
            blocks[rel] = dataclasses.replace(b, shape=shape)
            continue
        n_src, n_dst = indices[src_t].size, indices[dst_t].size
        for name, pairs in (("add", e.add), ("remove", e.remove)):
            if pairs.size and (
                pairs.min() < 0
                or pairs[:, 0].max() >= n_src
                or pairs[:, 1].max() >= n_dst
            ):
                raise ValueError(
                    f"{rel} {name} endpoints out of range "
                    f"[{n_src}, {n_dst}) — append the nodes first"
                )
        existing = _edge_keys(b.rows, b.cols)
        add_keys = _edge_keys(e.add[:, 0], e.add[:, 1])
        rem_keys = _edge_keys(e.remove[:, 0], e.remove[:, 1])
        if np.unique(add_keys).shape[0] != add_keys.shape[0]:
            raise ValueError(f"{rel}: duplicate edges within the add set")
        if np.isin(add_keys, existing).any():
            raise ValueError(f"{rel}: add of an edge that already exists")
        if np.intersect1d(add_keys, rem_keys).size:
            raise ValueError(f"{rel}: edge both added and removed")
        if np.unique(rem_keys).shape[0] != rem_keys.shape[0]:
            raise ValueError(f"{rel}: duplicate edges within the remove set")
        rem_hit = np.isin(existing, rem_keys)
        if int(rem_hit.sum()) != rem_keys.shape[0]:
            raise ValueError(f"{rel}: remove of a nonexistent edge")
        blocks[rel] = AdjacencyBlock(
            relationship=rel,
            src_type=src_t,
            dst_type=dst_t,
            rows=np.concatenate(
                [b.rows[~rem_hit], e.add[:, 0].astype(np.int32)]
            ),
            cols=np.concatenate(
                [b.cols[~rem_hit], e.add[:, 1].astype(np.int32)]
            ),
            shape=shape,
        )

    return (
        EncodedHIN(
            schema=hin.schema, indices=indices, blocks=blocks, name=hin.name
        ),
        grew,
    )


# ---------------------------------------------------------------------------
# Planning (the serving-facing API)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeltaPlan:
    """Everything a warm service/backend needs to absorb one delta:
    the new HIN, the signed half-chain delta and patched factor (shared
    by every backend so nobody refolds), the affected score rows (a
    sound superset — the row-granular invalidation set), the chained
    fingerprint, and the fallback verdict."""

    delta: DeltaBatch
    hin_old: EncodedHIN
    hin_new: EncodedHIN
    fingerprint: str
    n_edge_changes: int
    fallback: bool
    reason: str | None = None
    delta_c: object | None = None  # ops.sparse.COOMatrix (signed ΔC)
    half_old: object | None = None  # pre-delta factor C
    half_new: object | None = None  # patched factor C
    affected_rows: np.ndarray | None = None  # sorted logical source rows


def half_chain_cached(hin: EncodedHIN, metapath):
    """The metapath's folded half-chain COO factor, memoized per HIN
    (``object.__setattr__`` on the frozen dataclass — same idiom as the
    fingerprint memo). plan_delta seeds the child HIN's entry with the
    patched factor, so a chain of deltas never refolds."""
    from ..ops import planner

    cache = hin.__dict__.get("_half_coo_cache")
    if cache is None:
        cache = {}
        object.__setattr__(hin, "_half_coo_cache", cache)
    c = cache.get(metapath.name)
    if c is None:
        c = cache[metapath.name] = planner.fold_half(hin, metapath).summed()
    return c


def _oriented_delta_blocks(hin: EncodedHIN, metapath, delta: DeltaBatch):
    """(old oriented COO blocks, signed oriented delta blocks) for the
    metapath's half chain — the product-rule inputs."""
    from ..ops import sparse as sp

    by_rel = {e.relationship: e for e in delta.edges}
    old_blocks, delta_blocks = [], []
    for st in metapath.half():
        b = hin.block(st.relationship)
        c = sp.coo_from_block(b)
        e = by_rel.get(st.relationship)
        if e is None:
            rows = np.empty(0, dtype=np.int64)
            cols = np.empty(0, dtype=np.int64)
            w = np.empty(0, dtype=np.float64)
        else:
            rows = np.concatenate([e.add[:, 0], e.remove[:, 0]])
            cols = np.concatenate([e.add[:, 1], e.remove[:, 1]])
            w = np.concatenate(
                [
                    np.ones(e.add.shape[0], dtype=np.float64),
                    -np.ones(e.remove.shape[0], dtype=np.float64),
                ]
            )
        d = sp.COOMatrix(rows=rows, cols=cols, weights=w, shape=c.shape)
        if st.reverse:
            c = sp.COOMatrix(
                rows=c.cols, cols=c.rows, weights=c.weights,
                shape=(c.shape[1], c.shape[0]),
            )
            d = sp.COOMatrix(
                rows=d.cols, cols=d.rows, weights=d.weights,
                shape=(d.shape[1], d.shape[0]),
            )
        old_blocks.append(c)
        delta_blocks.append(d)
    return old_blocks, delta_blocks


def plan_delta(
    hin: EncodedHIN,
    delta: DeltaBatch,
    metapath,
    max_delta_fraction: float = 0.05,
    grow_headroom: float = 0.25,
) -> DeltaPlan:
    """Apply ``delta`` and decide patch-vs-rebuild.

    The patch path requires: a symmetric metapath (the half-chain
    factorization is what makes O(Δ) possible), capacity headroom that
    absorbed any node appends (shapes unchanged), and a delta small
    enough that patching beats rebuilding (``max_delta_fraction`` of
    total edge nnz — past that the O(Δ·deg) products and the O(affected)
    invalidation converge on rebuild cost anyway)."""
    from ..ops import sparse as sp
    from ..serving.cache import chain_fingerprint, graph_fingerprint

    hin_new, grew = apply_delta(hin, delta, grow_headroom=grow_headroom)
    fp = chain_fingerprint(graph_fingerprint(hin), delta.digest())
    # Memoize the child fingerprint: nobody ever re-hashes the blocks.
    object.__setattr__(hin_new, "_fingerprint_cache", fp)

    n_changes = delta.n_edge_changes
    total_nnz = sum(b.nnz for b in hin.blocks.values())

    def _fallback(reason: str) -> DeltaPlan:
        return DeltaPlan(
            delta=delta, hin_old=hin, hin_new=hin_new, fingerprint=fp,
            n_edge_changes=n_changes, fallback=True, reason=reason,
        )

    if grew:
        return _fallback("headroom exhausted: index capacity grew")
    if not metapath.is_symmetric:
        return _fallback(f"metapath {metapath.name} is not symmetric")
    if n_changes > max_delta_fraction * max(total_nnz, 1):
        return _fallback(
            f"delta of {n_changes} edge changes exceeds "
            f"{max_delta_fraction:.0%} of {total_nnz} edges"
        )

    c_old = half_chain_cached(hin, metapath)
    old_blocks, delta_blocks = _oriented_delta_blocks(hin, metapath, delta)
    delta_c = sp.coo_delta_fold(old_blocks, delta_blocks)
    c_new = sp.coo_apply_delta(c_old, delta_c)
    # Seed the child's factor cache: the next delta folds nothing.
    object.__setattr__(hin_new, "_half_coo_cache", {metapath.name: c_new})
    affected = sp.affected_source_rows(
        c_old, c_new, delta_c,
        n_logical=hin_new.type_size(metapath.source_type),
    )
    return DeltaPlan(
        delta=delta, hin_old=hin, hin_new=hin_new, fingerprint=fp,
        n_edge_changes=n_changes, fallback=False,
        delta_c=delta_c, half_old=c_old, half_new=c_new,
        affected_rows=affected,
    )


# ---------------------------------------------------------------------------
# Coalescing (the firehose batching primitive)
# ---------------------------------------------------------------------------


class NotCoalescable(ValueError):
    """The batches cannot fold into one (a within-window conflict —
    e.g. the same edge added twice — that only sequential application
    can express). Callers fall back to applying them one by one."""


def coalesce_deltas(batches) -> DeltaBatch:
    """Fold K *sequentially valid* delta batches into ONE batch whose
    application produces the identical graph (the router's firehose
    batching: the product-rule ΔC composes, so K broadcasts become
    one). Edge changes cancel pairwise — ``add e`` then ``remove e``
    (or remove then re-add) nets to nothing, which is exactly what the
    sequential chain produces — and node appends concatenate in order
    (later batches' edges may reference earlier batches' appends).

    Raises :class:`NotCoalescable` on transitions a single batch
    cannot express (add-after-add, remove-after-remove of one edge, or
    colliding appended ids): such sequences were invalid sequentially
    anyway, or need the window split. The coalesced result equals the
    sequential chain's bit for bit (tests/test_torch_delta.py)."""
    batches = list(batches)
    if not batches:
        return DeltaBatch()
    if len(batches) == 1:
        return batches[0]
    appends: dict[str, dict] = {}  # type → {"ids": [...], "labels": [...], "count": n}
    seen_ids: dict[str, set] = {}
    net: dict[str, dict[tuple[int, int], int]] = {}
    for batch in batches:
        for a in batch.nodes:
            slot = appends.setdefault(
                a.node_type, {"ids": [], "labels": [], "count": 0}
            )
            if a.ids:
                ids_seen = seen_ids.setdefault(a.node_type, set())
                for i in a.ids:
                    if i in ids_seen:
                        raise NotCoalescable(
                            f"node id {i!r} appended twice in window"
                        )
                    ids_seen.add(i)
                slot["ids"].extend(a.ids)
                slot["labels"].extend(a.labels or a.ids)
            else:
                slot["count"] += a.count
        for e in batch.edges:
            m = net.setdefault(e.relationship, {})
            for pairs, sign in ((e.add, 1), (e.remove, -1)):
                for row in pairs:
                    key = (int(row[0]), int(row[1]))
                    cur = m.get(key, 0)
                    if cur == sign:
                        raise NotCoalescable(
                            f"{e.relationship}: edge {key} "
                            f"{'added' if sign > 0 else 'removed'} "
                            "twice in window"
                        )
                    if cur == 0:
                        m[key] = sign
                    else:
                        del m[key]  # add+remove (either order) cancels
    for t, slot in appends.items():
        if slot["ids"] and slot["count"]:
            # a type is either materialized (id appends) or implicit
            # (count appends); a window mixing them was invalid
            # sequentially too — refuse rather than drop either half
            raise NotCoalescable(f"type {t!r} mixes id and count appends")
    nodes = tuple(
        NodeAppend(
            node_type=t,
            ids=tuple(slot["ids"]),
            labels=tuple(slot["labels"]),
            count=slot["count"] if not slot["ids"] else 0,
        )
        for t, slot in appends.items()
        if slot["ids"] or slot["count"]
    )
    edges = tuple(
        edge_delta(
            rel,
            add=[k for k, s in m.items() if s > 0],
            remove=[k for k, s in m.items() if s < 0],
        )
        for rel, m in sorted(net.items())
        if m
    )
    return DeltaBatch(edges=edges, nodes=nodes)


# ---------------------------------------------------------------------------
# Wire-format construction (the JSONL ``update`` op)
# ---------------------------------------------------------------------------


def delta_from_records(
    hin: EncodedHIN,
    add_nodes=(),
    add_edges=(),
    remove_edges=(),
) -> DeltaBatch:
    """Build a DeltaBatch from id-level records (the protocol layer's
    shape)::

        add_nodes:    [{"type": "author", "id": "a9", "label": "Ada"}]
        add_edges:    [{"rel": "author_of", "src": "a9", "dst": "p3"}]
        remove_edges: [{"rel": "author_of", "src_row": 4, "dst_row": 17}]

    Endpoints resolve by id (``src``/``dst``) or raw dense index
    (``src_row``/``dst_row``); ids of nodes appended in the same batch
    resolve to their future indices."""
    appends: dict[str, list[tuple[str, str]]] = {}
    for rec in add_nodes:
        t = rec["type"]
        appends.setdefault(t, []).append(
            (rec["id"], rec.get("label", rec["id"]))
        )
    pending: dict[str, dict[str, int]] = {}
    nodes = []
    for t, pairs in appends.items():
        idx = hin.indices[t]
        pending[t] = {
            i: idx.size + k for k, (i, _) in enumerate(pairs)
        }
        nodes.append(
            NodeAppend(
                node_type=t,
                ids=tuple(p[0] for p in pairs),
                labels=tuple(p[1] for p in pairs),
            )
        )

    def resolve(node_type: str, rec: dict, side: str) -> int:
        row = rec.get(f"{side}_row")
        if row is not None:
            return int(row)
        node_id = rec.get(side)
        if node_id is None:
            raise KeyError(f"edge record needs {side} or {side}_row")
        idx = hin.indices[node_type].index_of.get(node_id)
        if idx is None:
            idx = pending.get(node_type, {}).get(node_id)
        if idx is None:
            raise KeyError(f"no {node_type} with id {node_id!r}")
        return idx

    adds: dict[str, list[tuple[int, int]]] = {}
    rems: dict[str, list[tuple[int, int]]] = {}
    for out, records in ((adds, add_edges), (rems, remove_edges)):
        for rec in records:
            rel = rec["rel"]
            sig = hin.schema.relations.get(rel)
            if sig is None:
                raise KeyError(f"unknown relationship {rel!r}")
            src_t, dst_t = sig
            out.setdefault(rel, []).append(
                (resolve(src_t, rec, "src"), resolve(dst_t, rec, "dst"))
            )
    edges = tuple(
        edge_delta(rel, add=adds.get(rel, ()), remove=rems.get(rel, ()))
        for rel in sorted(set(adds) | set(rems))
    )
    return DeltaBatch(edges=edges, nodes=tuple(nodes))
