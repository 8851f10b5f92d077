"""ctypes bridge to the C++ GEXF parser (gexf_fast.cpp).

Same output as data/gexf.py's Python parser — document order, dedup and
attvalue semantics included — but a single native pass over the file.
Falls back cleanly (available() → False) when the toolchain is missing.
"""

from __future__ import annotations

import ctypes

from ..data.schema import Edge, HINGraph, Vertex
from .build import shared_lib

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = shared_lib("gexf_fast")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # built for another host's C++ runtime
        return None
    lib.gexf_parse.restype = ctypes.c_void_p
    lib.gexf_parse.argtypes = [ctypes.c_char_p]
    lib.gexf_num_nodes.restype = ctypes.c_long
    lib.gexf_num_nodes.argtypes = [ctypes.c_void_p]
    lib.gexf_num_edges.restype = ctypes.c_long
    lib.gexf_num_edges.argtypes = [ctypes.c_void_p]
    lib.gexf_nodes_blob.restype = ctypes.POINTER(ctypes.c_char)
    lib.gexf_nodes_blob.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.gexf_edges_blob.restype = ctypes.POINTER(ctypes.c_char)
    lib.gexf_edges_blob.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.gexf_graph_name.restype = ctypes.c_char_p
    lib.gexf_graph_name.argtypes = [ctypes.c_void_p]
    lib.gexf_error.restype = ctypes.c_char_p
    lib.gexf_error.argtypes = [ctypes.c_void_p]
    lib.gexf_free.restype = None
    lib.gexf_free.argtypes = [ctypes.c_void_p]
    # encoded view
    lib.gexf_encode.restype = ctypes.c_void_p
    lib.gexf_encode.argtypes = [ctypes.c_void_p]
    lib.genc_num_types.restype = ctypes.c_long
    lib.genc_num_types.argtypes = [ctypes.c_void_p]
    lib.genc_type_names.restype = ctypes.POINTER(ctypes.c_char)
    lib.genc_type_names.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.genc_type_counts.restype = ctypes.POINTER(ctypes.c_long)
    lib.genc_type_counts.argtypes = [ctypes.c_void_p]
    lib.genc_nodes_blob.restype = ctypes.POINTER(ctypes.c_char)
    lib.genc_nodes_blob.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.genc_node_offsets.restype = ctypes.POINTER(ctypes.c_long)
    lib.genc_node_offsets.argtypes = [ctypes.c_void_p]
    lib.genc_num_rels.restype = ctypes.c_long
    lib.genc_num_rels.argtypes = [ctypes.c_void_p]
    lib.genc_rel_names.restype = ctypes.POINTER(ctypes.c_char)
    lib.genc_rel_names.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.genc_rel_types.restype = ctypes.POINTER(ctypes.c_int)
    lib.genc_rel_types.argtypes = [ctypes.c_void_p]
    lib.genc_rel_offsets.restype = ctypes.POINTER(ctypes.c_long)
    lib.genc_rel_offsets.argtypes = [ctypes.c_void_p]
    lib.genc_rows.restype = ctypes.POINTER(ctypes.c_int)
    lib.genc_rows.argtypes = [ctypes.c_void_p]
    lib.genc_cols.restype = ctypes.POINTER(ctypes.c_int)
    lib.genc_cols.argtypes = [ctypes.c_void_p]
    lib.genc_error.restype = ctypes.c_char_p
    lib.genc_error.argtypes = [ctypes.c_void_p]
    lib.genc_free.restype = None
    lib.genc_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_gexf(path: str) -> HINGraph:
    lib = _load()
    if lib is None:
        raise RuntimeError("native GEXF parser unavailable")
    handle = lib.gexf_parse(path.encode())
    try:
        err = lib.gexf_error(handle)
        if err:
            raise ValueError(f"GEXF parse error: {err.decode()}")
        n_nodes = lib.gexf_num_nodes(handle)
        n_edges = lib.gexf_num_edges(handle)
        graph_name = (lib.gexf_graph_name(handle) or b"").decode("utf-8")

        length = ctypes.c_long()
        buf = lib.gexf_nodes_blob(handle, ctypes.byref(length))
        node_fields = (
            ctypes.string_at(buf, length.value).decode("utf-8").split("\0")
            if length.value
            else []
        )
        buf = lib.gexf_edges_blob(handle, ctypes.byref(length))
        edge_fields = (
            ctypes.string_at(buf, length.value).decode("utf-8").split("\0")
            if length.value
            else []
        )
    finally:
        lib.gexf_free(handle)

    # blobs end with a trailing NUL → drop the final empty split
    if node_fields and node_fields[-1] == "":
        node_fields.pop()
    if edge_fields and edge_fields[-1] == "":
        edge_fields.pop()
    if len(node_fields) != 3 * n_nodes or len(edge_fields) != 3 * n_edges:
        raise ValueError("native GEXF parser returned inconsistent blobs")

    vertices = [
        Vertex(id=node_fields[i], label=node_fields[i + 1], node_type=node_fields[i + 2])
        for i in range(0, len(node_fields), 3)
    ]
    edges = [
        Edge(src=edge_fields[i], dst=edge_fields[i + 1], relationship=edge_fields[i + 2])
        for i in range(0, len(edge_fields), 3)
    ]
    return HINGraph(vertices=vertices, edges=edges, name=graph_name)


def read_gexf_encoded(path: str):
    """Parse AND encode natively: GEXF file → :class:`EncodedHIN` with
    no per-edge Python objects ever created.

    Equivalent to ``encode_hin(read_gexf(path))`` (same type/relationship
    order, same per-type document-order indices, same duplicate-id and
    mixed-signature semantics — tested against it), but edge endpoints
    are resolved to dense int32 COO in C++. At dblp_large scale the
    Python-object marshalling dominates the pure-parse path, so this is
    the loader the engine uses for big files.
    """
    import numpy as np

    from ..data.encode import AdjacencyBlock, EncodedHIN, TypeIndex
    from ..data.schema import HINSchema

    lib = _load()
    if lib is None:
        raise RuntimeError("native GEXF parser unavailable")
    handle = lib.gexf_parse(path.encode())
    enc = None
    try:
        err = lib.gexf_error(handle)
        if err:
            raise ValueError(f"GEXF parse error: {err.decode()}")
        graph_name = (lib.gexf_graph_name(handle) or b"").decode("utf-8")
        enc = lib.gexf_encode(handle)
        err = lib.genc_error(enc)
        if err:
            raise ValueError(err.decode())

        n_types = lib.genc_num_types(enc)
        length = ctypes.c_long()
        buf = lib.genc_type_names(enc, ctypes.byref(length))
        type_names = (
            ctypes.string_at(buf, length.value).decode("utf-8").split("\0")[:-1]
            if length.value else []
        )
        counts = lib.genc_type_counts(enc)[:n_types] if n_types else []
        offsets = lib.genc_node_offsets(enc)[: n_types + 1]
        buf = lib.genc_nodes_blob(enc, ctypes.byref(length))
        nodes_raw = ctypes.string_at(buf, length.value) if length.value else b""

        indices: dict[str, TypeIndex] = {}
        for t, tname in enumerate(type_names):
            section = nodes_raw[offsets[t]:offsets[t + 1]]
            fields = section.decode("utf-8").split("\0")
            if fields and fields[-1] == "":
                fields.pop()
            assert len(fields) == 2 * counts[t], "inconsistent node section"
            ids = tuple(fields[0::2])
            labels = tuple(fields[1::2])
            indices[tname] = TypeIndex(
                node_type=tname,
                ids=ids,
                labels=labels,
                index_of={s: i for i, s in enumerate(ids)},
            )

        n_rels = lib.genc_num_rels(enc)
        buf = lib.genc_rel_names(enc, ctypes.byref(length))
        rel_names = (
            ctypes.string_at(buf, length.value).decode("utf-8").split("\0")[:-1]
            if length.value else []
        )
        rel_types = lib.genc_rel_types(enc)[: 2 * n_rels] if n_rels else []
        rel_offsets = lib.genc_rel_offsets(enc)[: n_rels + 1]
        total = rel_offsets[n_rels] if n_rels else 0
        if total:
            rows_all = np.ctypeslib.as_array(lib.genc_rows(enc), shape=(total,))
            cols_all = np.ctypeslib.as_array(lib.genc_cols(enc), shape=(total,))
        else:  # zero edges: vector data() is NULL, as_array would raise
            rows_all = cols_all = np.empty(0, dtype=np.int32)

        relations: dict[str, tuple[str, str]] = {}
        blocks: dict[str, AdjacencyBlock] = {}
        for r, rel in enumerate(rel_names):
            src_t = type_names[rel_types[2 * r]]
            dst_t = type_names[rel_types[2 * r + 1]]
            relations[rel] = (src_t, dst_t)
            lo, hi = rel_offsets[r], rel_offsets[r + 1]
            blocks[rel] = AdjacencyBlock(
                relationship=rel,
                src_type=src_t,
                dst_type=dst_t,
                # copy out: the backing buffer dies with genc_free
                rows=np.array(rows_all[lo:hi], dtype=np.int32),
                cols=np.array(cols_all[lo:hi], dtype=np.int32),
                shape=(indices[src_t].size, indices[dst_t].size),
            )
        schema = HINSchema(node_types=tuple(type_names), relations=relations)
        return EncodedHIN(
            schema=schema, indices=indices, blocks=blocks, name=graph_name
        )
    finally:
        if enc is not None:
            lib.genc_free(enc)
        lib.gexf_free(handle)
