"""Synthetic DBLP-like HIN generator.

Generates author/paper/venue(/topic) graphs at arbitrary scale with
power-law-ish venue popularity and small per-paper author lists, directly
as an :class:`EncodedHIN` (no string round-trip — at 1M authors / 5M
papers the id strings would dominate memory). A small-scale GEXF writer is
also provided so loader tests have realistic files.

The numpy draws are the JAX package's, in the same order, so one seed
gives the same graph in both packages.
"""

from __future__ import annotations

import numpy as np

from .encode import AdjacencyBlock, EncodedHIN, TypeIndex
from .schema import HINSchema

DBLP_SCHEMA = HINSchema(
    node_types=("author", "paper", "venue", "topic"),
    relations={
        "author_of": ("author", "paper"),
        "submit_at": ("paper", "venue"),
        "has_topic": ("paper", "topic"),
    },
)


def synthetic_hin(
    n_authors: int,
    n_papers: int,
    n_venues: int,
    n_topics: int = 0,
    authors_per_paper: float = 1.3,
    topics_per_paper: float = 1.0,
    seed: int = 0,
    materialize_ids: bool = False,
) -> EncodedHIN:
    """Build a synthetic DBLP-shaped HIN.

    Structure mirrors the real data's invariants: every paper has exactly
    one venue (``submit_at`` nnz == n_papers, as in dblp_small), papers have
    ~``authors_per_paper`` authors, venues have Zipf-like popularity so the
    commuting-matrix row sums spread over orders of magnitude like the
    reference log's global walks (876 … 11631).
    """
    rng = np.random.default_rng(seed)

    # author_of: each paper gets 1 + Poisson(extra) distinct authors, biased
    # to a Zipf head so a few authors are prolific (Jiawei-Han-like rows).
    extra = rng.poisson(max(authors_per_paper - 1.0, 0.0), size=n_papers)
    counts = 1 + extra
    total = int(counts.sum())
    zipf_w = 1.0 / np.arange(1, n_authors + 1, dtype=np.float64)
    zipf_w /= zipf_w.sum()
    authors = rng.choice(n_authors, size=total, p=zipf_w)
    papers = np.repeat(np.arange(n_papers, dtype=np.int64), counts)
    ap = np.unique(np.stack([authors, papers], axis=1), axis=0)

    # submit_at: exactly one venue per paper, Zipf venue popularity.
    venue_w = 1.0 / np.arange(1, n_venues + 1, dtype=np.float64)
    venue_w /= venue_w.sum()
    venues = rng.choice(n_venues, size=n_papers, p=venue_w)
    pv_rows = np.arange(n_papers, dtype=np.int64)

    relations = {
        "author_of": ("author", "paper"),
        "submit_at": ("paper", "venue"),
    }
    blocks = {
        "author_of": AdjacencyBlock(
            relationship="author_of",
            src_type="author",
            dst_type="paper",
            rows=ap[:, 0].astype(np.int32),
            cols=ap[:, 1].astype(np.int32),
            shape=(n_authors, n_papers),
        ),
        "submit_at": AdjacencyBlock(
            relationship="submit_at",
            src_type="paper",
            dst_type="venue",
            rows=pv_rows.astype(np.int32),
            cols=venues.astype(np.int32),
            shape=(n_papers, n_venues),
        ),
    }

    sizes = {"author": n_authors, "paper": n_papers, "venue": n_venues}
    node_types = ["author", "paper", "venue"]
    if n_topics > 0:
        n_pt = int(round(topics_per_paper * n_papers))
        pt_papers = rng.integers(0, n_papers, size=n_pt)
        pt_topics = rng.integers(0, n_topics, size=n_pt)
        pt = np.unique(np.stack([pt_papers, pt_topics], axis=1), axis=0)
        relations["has_topic"] = ("paper", "topic")
        blocks["has_topic"] = AdjacencyBlock(
            relationship="has_topic",
            src_type="paper",
            dst_type="topic",
            rows=pt[:, 0].astype(np.int32),
            cols=pt[:, 1].astype(np.int32),
            shape=(n_papers, n_topics),
        )
        sizes["topic"] = n_topics
        node_types.append("topic")

    indices = {t: _range_index(t, sizes[t], materialize_ids) for t in node_types}
    schema = HINSchema(node_types=tuple(node_types), relations=relations)
    return EncodedHIN(
        schema=schema,
        indices=indices,
        blocks=blocks,
        name=f"synthetic_a{n_authors}_p{n_papers}_v{n_venues}",
    )


def _range_index(node_type: str, size: int, materialize: bool) -> TypeIndex:
    if materialize:
        ids = tuple(f"{node_type}_{i}" for i in range(size))
        return TypeIndex(
            node_type=node_type,
            ids=ids,
            labels=ids,
            index_of={s: i for i, s in enumerate(ids)},
        )
    # At 1M+ nodes, per-node Python strings cost more than the graph itself;
    # the index spaces are pure ranges — keep them implicit but sized.
    return TypeIndex(
        node_type=node_type, ids=(), labels=(), index_of={}, size_override=size
    )


def write_gexf(hin: EncodedHIN, path: str) -> None:
    """Write an EncodedHIN as GEXF 1.2 in the reference's dialect
    (NetworkX-2.0-style: node_type as node attvalue 0, relationship as
    edge attvalue titled 'label'). Streams to the file — dblp_large-scale
    graphs (millions of nodes, ~1 GB of XML) must not be built as one
    in-memory string."""
    from xml.sax.saxutils import quoteattr

    with open(path, "w", encoding="utf-8") as f:
        w = f.write
        w("<?xml version='1.0' encoding='utf-8'?>\n")
        w('<gexf version="1.2" xmlns="http://www.gexf.net/1.2draft">\n')
        w(
            f'  <graph defaultedgetype="directed" mode="static" '
            f"name={quoteattr(hin.name)}>\n"
        )
        w('    <attributes class="edge" mode="static">\n')
        w('      <attribute id="1" title="label" type="string" />\n')
        w("    </attributes>\n")
        w('    <attributes class="node" mode="static">\n')
        w('      <attribute id="0" title="node_type" type="string" />\n')
        w("    </attributes>\n")
        w("    <nodes>\n")
        for t in hin.schema.node_types:
            idx = hin.indices[t]
            n = idx.size
            if n and not idx.ids:
                raise ValueError(
                    "write_gexf needs materialized ids; build the HIN with "
                    "materialize_ids=True"
                )
            tq = quoteattr(t)
            for i in range(n):
                w(
                    f"      <node id={quoteattr(idx.ids[i])} "
                    f"label={quoteattr(idx.labels[i])}>"
                    f'<attvalues><attvalue for="0" value={tq} />'
                    f"</attvalues></node>\n"
                )
        w("    </nodes>\n")
        w("    <edges>\n")
        k = 0
        for rel, b in hin.blocks.items():
            src_ids = hin.indices[b.src_type].ids
            dst_ids = hin.indices[b.dst_type].ids
            relq = quoteattr(rel)
            for r, c in zip(b.rows.tolist(), b.cols.tolist()):
                w(
                    f'      <edge id="{k}" source={quoteattr(src_ids[r])} '
                    f"target={quoteattr(dst_ids[c])}>"
                    f'<attvalues><attvalue for="1" value={relq} />'
                    f"</attvalues></edge>\n"
                )
                k += 1
        w("    </edges>\n")
        w("  </graph>\n")
        w("</gexf>\n")
