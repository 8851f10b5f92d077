"""Typed-adjacency encoding: host strings → device-ready dense indices.

The reference ships raw string tuple-lists into Spark DataFrames and lets
Catalyst join on strings (``DPathSim_APVPA.py:160-163``). Here every node
type gets its own contiguous dense index space on the host, and each
relationship becomes a COO block of ``(row, col)`` int32 index pairs
between two type spaces. Everything downstream (the host fold, the dense
torch backend, the CUDA kernels) consumes these blocks; strings never
reach the device.

:func:`encoded_hin_from_arrays` rebuilds an :class:`EncodedHIN` from a
plain dict of numpy arrays and strings, so a graph built by another
program (the JAX package, a file) can be carried across without either
side importing the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schema import HINGraph, HINSchema, infer_schema


@dataclasses.dataclass(frozen=True)
class TypeIndex:
    """Bidirectional id↔dense-index map for one node type.

    Index order is vertex file order, which is the reference's iteration
    (and log) order. ``size_override`` supports huge synthetic graphs
    whose ids are implicit ranges (no per-node strings); such indices
    still report the correct size but cannot resolve string ids.

    ``capacity`` (when set) reserves index slots beyond ``size`` — the
    delta-ingestion headroom (data/delta.py): adjacency blocks are built
    at capacity shape so node appends up to the reserve never change any
    array shape (and therefore never invalidate a compiled program).
    Slots in ``[size, capacity)`` carry no edges and are invisible to
    every logical-size consumer.
    """

    node_type: str
    ids: tuple[str, ...]
    labels: tuple[str, ...]
    index_of: dict[str, int]
    size_override: int | None = None
    capacity: int | None = None

    @property
    def size(self) -> int:
        """Logical node count (never the padded capacity)."""
        return self.size_override if self.size_override is not None else len(self.ids)

    @property
    def padded_size(self) -> int:
        """Array-shape size: capacity when headroom is reserved, else
        the logical size."""
        return self.capacity if self.capacity is not None else self.size

    @property
    def headroom(self) -> int:
        return self.padded_size - self.size

    def label_of_index(self, i: int) -> str:
        return self.labels[i]

    def index_of_label(self, label: str) -> int | None:
        """Label → first dense index, O(1) via a lazily built map.

        Labels are not unique (author names collide); ``labels.index``
        semantics — first occurrence wins — are preserved by the
        setdefault construction. The map is built once per TypeIndex
        (frozen dataclass: cached via ``object.__setattr__``) instead of
        paying an O(N) list scan on every serving-path resolve."""
        cache = self.__dict__.get("_label_index")
        if cache is None:
            cache = {}
            for i, lab in enumerate(self.labels):
                cache.setdefault(lab, i)
            object.__setattr__(self, "_label_index", cache)
        return cache.get(label)


@dataclasses.dataclass(frozen=True)
class AdjacencyBlock:
    """COO adjacency block for one relationship: rows in ``src_type``'s
    index space, cols in ``dst_type``'s. Entries are unique (simple graph —
    see gexf.py dedup) and unweighted (weight 1, like the reference data).
    """

    relationship: str
    src_type: str
    dst_type: str
    rows: np.ndarray  # int32 [nnz]
    cols: np.ndarray  # int32 [nnz]
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        out[self.rows, self.cols] = 1
        return out

    def transpose(self) -> "AdjacencyBlock":
        return AdjacencyBlock(
            relationship=self.relationship + "^T",
            src_type=self.dst_type,
            dst_type=self.src_type,
            rows=self.cols,
            cols=self.rows,
            shape=(self.shape[1], self.shape[0]),
        )


@dataclasses.dataclass(frozen=True)
class EncodedHIN:
    """A fully encoded HIN: schema + per-type index spaces + COO blocks."""

    schema: HINSchema
    indices: dict[str, TypeIndex]
    blocks: dict[str, AdjacencyBlock]  # keyed by relationship name
    name: str = ""

    def type_size(self, node_type: str) -> int:
        return self.indices[node_type].size

    def block(self, relationship: str) -> AdjacencyBlock:
        return self.blocks[relationship]

    def find_index_by_label(self, node_type: str, label: str) -> int | None:
        """Label→dense index within a type (the reference's name→id lookup,
        ``DPathSim_APVPA.py:132-137``, composed with index encoding).
        O(1): this sits on the per-request serving path (resolve_source)."""
        return self.indices[node_type].index_of_label(label)

    def resolve_source(
        self,
        node_type: str,
        label: str | None = None,
        node_id: str | None = None,
    ) -> int:
        """Label-or-id → dense index, with the canonical not-found
        messages (shared by the driver and both CLIs — the reference
        crashes opaquely on an unknown source, SURVEY.md §3.1)."""
        if label is not None:
            idx = self.find_index_by_label(node_type, label)
            if idx is None:
                raise KeyError(f"no {node_type} labeled {label!r}")
            return idx
        idx = self.indices[node_type].index_of.get(node_id)
        if idx is None:
            raise KeyError(f"no {node_type} with id {node_id!r}")
        return idx


def encode_hin(graph: HINGraph, schema: HINSchema | None = None) -> EncodedHIN:
    """Encode a host graph into typed index spaces and COO blocks.

    Edges whose endpoints are missing from the vertex table are rejected;
    edges whose relationship has no schema entry are rejected. Isolated
    nodes (e.g. dblp_small's 10 ``topic`` nodes) still get index entries —
    they simply appear in no block.
    """
    if schema is None:
        schema = infer_schema(graph)

    per_type: dict[str, list[tuple[str, str]]] = {t: [] for t in schema.node_types}
    for v in graph.vertices:
        per_type.setdefault(v.node_type, []).append((v.id, v.label))

    indices: dict[str, TypeIndex] = {}
    for node_type, pairs in per_type.items():
        ids = tuple(p[0] for p in pairs)
        labels = tuple(p[1] for p in pairs)
        indices[node_type] = TypeIndex(
            node_type=node_type,
            ids=ids,
            labels=labels,
            index_of={i: k for k, i in enumerate(ids)},
        )

    per_rel: dict[str, tuple[list[int], list[int]]] = {
        r: ([], []) for r in schema.relations
    }
    for e in graph.edges:
        sig = schema.relations.get(e.relationship)
        if sig is None:
            raise ValueError(f"edge relationship {e.relationship!r} not in schema")
        src_type, dst_type = sig
        rows, cols = per_rel[e.relationship]
        rows.append(indices[src_type].index_of[e.src])
        cols.append(indices[dst_type].index_of[e.dst])

    blocks: dict[str, AdjacencyBlock] = {}
    for rel, (rows, cols) in per_rel.items():
        src_type, dst_type = schema.relations[rel]
        blocks[rel] = AdjacencyBlock(
            relationship=rel,
            src_type=src_type,
            dst_type=dst_type,
            rows=np.asarray(rows, dtype=np.int32),
            cols=np.asarray(cols, dtype=np.int32),
            shape=(indices[src_type].size, indices[dst_type].size),
        )

    return EncodedHIN(schema=schema, indices=indices, blocks=blocks, name=graph.name)


def encoded_hin_from_arrays(state: dict) -> EncodedHIN:
    """Build an :class:`EncodedHIN` from a plain dict of arrays/strings.

    ``state`` holds ``node_types`` (sequence of type names),
    ``relations`` (name → (src_type, dst_type)), ``types`` (type →
    ``{"ids", "labels"}`` sequences, or ``{"size"}`` alone for an
    implicit-range index with no per-node strings), ``blocks`` (name →
    ``{"relationship", "src_type", "dst_type", "rows", "cols",
    "shape"}``) and optionally ``name``. Arrays are copied, so the
    result shares no buffer with the caller."""
    schema = HINSchema(
        node_types=tuple(state["node_types"]),
        relations={
            r: (str(sig[0]), str(sig[1]))
            for r, sig in state["relations"].items()
        },
    )
    indices: dict[str, TypeIndex] = {}
    for node_type, t in state["types"].items():
        ids = tuple(str(i) for i in t.get("ids", ()))
        labels = tuple(str(x) for x in t.get("labels", ()))
        if len(ids) != len(labels):
            raise ValueError(
                f"type {node_type!r}: {len(ids)} ids but {len(labels)} labels"
            )
        size = t.get("size")
        indices[node_type] = TypeIndex(
            node_type=node_type,
            ids=ids,
            labels=labels,
            index_of={i: k for k, i in enumerate(ids)},
            size_override=None if ids or size is None else int(size),
        )
    blocks: dict[str, AdjacencyBlock] = {}
    for rel, b in state["blocks"].items():
        rows = np.array(b["rows"], dtype=np.int32)
        cols = np.array(b["cols"], dtype=np.int32)
        if rows.shape != cols.shape:
            raise ValueError(f"block {rel!r}: rows/cols length mismatch")
        blocks[rel] = AdjacencyBlock(
            relationship=str(b["relationship"]),
            src_type=str(b["src_type"]),
            dst_type=str(b["dst_type"]),
            rows=rows,
            cols=cols,
            shape=(int(b["shape"][0]), int(b["shape"][1])),
        )
    return EncodedHIN(
        schema=schema, indices=indices, blocks=blocks,
        name=str(state.get("name", "")),
    )


def factor_from_arrays(c: np.ndarray, d: np.ndarray, device):
    """Hand a numpy half factor ``c`` [N, V] and its denominators ``d``
    [N] to the kernels: contiguous float32 tensors on ``device``."""
    import torch

    c = np.asarray(c)
    d = np.asarray(d)
    if c.ndim != 2 or d.shape != (c.shape[0],):
        raise ValueError(f"factor shapes {c.shape} / {d.shape} do not match")
    return (
        torch.as_tensor(np.ascontiguousarray(c, dtype=np.float32), device=device),
        torch.as_tensor(np.ascontiguousarray(d, dtype=np.float32), device=device),
    )
