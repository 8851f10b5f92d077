"""GEXF ingestion (reference component C1, ``DPathSim_APVPA.py:114-129``).

The reference reads GEXF through ``networkx.read_gexf`` and flattens to
tuple lists. We parse the XML directly with a streaming ``iterparse`` —
no networkx dependency, no intermediate graph object, O(E) memory — and
optionally through the C++ fast parser in ``native/`` for large files.

Semantics matched to the reference pipeline:
- node attvalue titled ``node_type`` → vertex node_type
- edge attvalue titled ``label`` → edge *relationship* (the reference
  stores the relationship under the GEXF attribute titled "label",
  SURVEY.md §3.4)
- multi-edges are deduplicated (networkx yields a simple DiGraph, so
  ``distinct()`` in the reference is a no-op — we reproduce that by
  dedup at ingestion, SURVEY.md §3.3)
- file order of nodes/edges is preserved (drives target iteration order)
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from .schema import Edge, HINGraph, Vertex


def _local(tag: str) -> str:
    """Strip any XML namespace from a tag."""
    return tag.rsplit("}", 1)[-1]


def read_gexf(path: str, use_native: bool | None = None) -> HINGraph:
    """Parse a GEXF file into a typed :class:`HINGraph`.

    ``use_native``: force (True) or forbid (False) the C++ parser;
    ``None`` auto-selects it when the shared library is available.
    """
    if use_native is not False:
        try:
            from ..native import gexf_native

            if gexf_native.available():
                return gexf_native.read_gexf(path)
            if use_native is True:
                raise RuntimeError("native GEXF parser requested but unavailable")
        except ImportError:
            if use_native is True:
                raise
    return _read_gexf_python(path)


def _read_gexf_python(path: str) -> HINGraph:
    # Two-level state machine over iterparse events: attribute declarations
    # give us attr-id → title maps per class; then nodes/edges stream out.
    node_attr_titles: dict[str, str] = {}
    edge_attr_titles: dict[str, str] = {}

    vertices: list[Vertex] = []
    # (src, dst) → position in `edges`; duplicate (src, dst) pairs keep their
    # first position but take the last relationship — exactly what
    # nx.read_gexf's DiGraph edge-attribute overwrite does in the reference.
    edge_pos: dict[tuple[str, str], int] = {}
    edges: list[Edge] = []
    graph_name = ""

    cur_attr_class: str | None = None

    for event, elem in ET.iterparse(path, events=("start", "end")):
        tag = _local(elem.tag)
        if event == "start":
            if tag == "attributes":
                cur_attr_class = elem.get("class")
            elif tag == "attribute" and cur_attr_class is not None:
                titles = (
                    node_attr_titles if cur_attr_class == "node" else edge_attr_titles
                )
                titles[elem.get("id", "")] = elem.get("title", "")
            elif tag == "graph":
                graph_name = elem.get("name", "") or ""
            continue

        # end events
        if tag == "attributes":
            cur_attr_class = None
        elif tag == "node":
            attrs = _attvalues(elem, node_attr_titles)
            vertices.append(
                Vertex(
                    id=elem.get("id", ""),
                    label=elem.get("label", elem.get("id", "")),
                    node_type=attrs.get("node_type", ""),
                )
            )
            elem.clear()
        elif tag == "edge":
            attrs = _attvalues(elem, edge_attr_titles)
            # GEXF edges may carry an explicit label attribute; the DBLP
            # data stores the relationship in the attvalue titled "label".
            rel = attrs.get("label", elem.get("label", ""))
            key = (elem.get("source", ""), elem.get("target", ""))
            pos = edge_pos.get(key)
            if pos is None:
                edge_pos[key] = len(edges)
                edges.append(Edge(src=key[0], dst=key[1], relationship=rel))
            else:
                edges[pos] = Edge(src=key[0], dst=key[1], relationship=rel)
            elem.clear()

    return HINGraph(vertices=vertices, edges=edges, name=graph_name)


def _attvalues(elem, titles: dict[str, str]) -> dict[str, str]:
    out: dict[str, str] = {}
    for child in elem.iter():
        if _local(child.tag) == "attvalue":
            attr_id = child.get("for", "")
            out[titles.get(attr_id, attr_id)] = child.get("value", "")
    return out
