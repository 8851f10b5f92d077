"""Typed heterogeneous-information-network (HIN) data model.

This is the framework's plugin boundary, kept content-compatible with the
reference's ingestion layer (``read_dblp_nx_file``, reference
``DPathSim_APVPA.py:114-129``): a graph is a list of
``(id, label, node_type)`` vertices and ``(src, dst, relationship)`` edges.
Unlike the reference — which ships these as Python tuple lists into Spark
DataFrames — we keep string ids strictly on the host and hand only dense
integer indices to the device (SURVEY.md §7 "String ids").
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class Vertex:
    id: str
    label: str
    node_type: str


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    relationship: str


@dataclasses.dataclass
class HINGraph:
    """Host-side typed graph: the content of a parsed GEXF file.

    ``vertices`` and ``edges`` preserve file order — the reference's target
    iteration order (and hence its log line order) is node insertion order,
    so order is semantically meaningful (SURVEY.md §4).
    """

    vertices: list[Vertex]
    edges: list[Edge]
    name: str = ""

    # ---- reference-compatible views -------------------------------------

    def vertex_tuples(self) -> list[tuple[str, str, str]]:
        """``(id, label, node_type)`` tuples, exactly what the reference's
        ``read_dblp_nx_file`` returns for vertices."""
        return [(v.id, v.label, v.node_type) for v in self.vertices]

    def edge_tuples(self) -> list[tuple[str, str, str]]:
        """``(src, dst, relationship)`` tuples, the reference's edge list."""
        return [(e.src, e.dst, e.relationship) for e in self.edges]

    # ---- lookups ---------------------------------------------------------

    def find_node_id_by_label(self, label: str) -> str | None:
        """Name→id resolution; linear scan like the reference
        (``DPathSim_APVPA.py:132-137``), returning ``None`` on a miss."""
        for v in self.vertices:
            if v.label == label:
                return v.id
        return None

    def node_types(self) -> list[str]:
        """Distinct node types in first-appearance order."""
        seen: dict[str, None] = {}
        for v in self.vertices:
            seen.setdefault(v.node_type, None)
        return list(seen)

    def relationships(self) -> list[str]:
        """Distinct edge relationships in first-appearance order."""
        seen: dict[str, None] = {}
        for e in self.edges:
            seen.setdefault(e.relationship, None)
        return list(seen)

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for v in self.vertices:
            out[v.node_type] = out.get(v.node_type, 0) + 1
        return out

    @staticmethod
    def from_tuples(
        vertices: Iterable[tuple[str, str, str]],
        edges: Iterable[tuple[str, str, str]],
        name: str = "",
    ) -> "HINGraph":
        return HINGraph(
            vertices=[Vertex(*t) for t in vertices],
            edges=[Edge(*t) for t in edges],
            name=name,
        )


@dataclasses.dataclass(frozen=True)
class HINSchema:
    """The type-level view of a HIN: node types and typed edge relations.

    ``relations`` maps a relationship name to its ``(src_type, dst_type)``
    signature — e.g. DBLP has ``author_of: (author, paper)`` and
    ``submit_at: (paper, venue)``.
    """

    node_types: tuple[str, ...]
    relations: Mapping[str, tuple[str, str]]

    def validate_metapath(self, node_seq: Sequence[str]) -> None:
        for t in node_seq:
            if t not in self.node_types:
                raise ValueError(
                    f"metapath node type {t!r} not in schema {self.node_types}"
                )


def infer_schema(graph: HINGraph) -> HINSchema:
    """Infer the typed schema from data.

    Every relationship must have a unique ``(src_type, dst_type)`` signature;
    mixed-signature relationships are rejected (the DBLP data is clean in
    this sense, and typed adjacency blocks require it).
    """
    type_of = {v.id: v.node_type for v in graph.vertices}
    relations: dict[str, tuple[str, str]] = {}
    for e in graph.edges:
        try:
            sig = (type_of[e.src], type_of[e.dst])
        except KeyError as exc:
            raise ValueError(f"edge endpoint {exc} has no vertex entry") from exc
        prev = relations.get(e.relationship)
        if prev is None:
            relations[e.relationship] = sig
        elif prev != sig:
            raise ValueError(
                f"relationship {e.relationship!r} has mixed signatures "
                f"{prev} vs {sig}"
            )
    return HINSchema(node_types=tuple(graph.node_types()), relations=relations)
