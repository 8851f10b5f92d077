"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
carrying a JAX-package graph across to the port as plain arrays,
comparing encoded graphs attribute by attribute, and the inputs and
runners that several parity files share (kernel factors, backend sets,
the CLI pair on one GEXF)."""

from __future__ import annotations

import contextlib
import functools
import pathlib

import numpy as np
import pytest

from distributed_pathsim_tpu_torch.data.encode import encoded_hin_from_arrays


def hin_state(hin) -> dict:
    """The plain-dict form of an EncodedHIN (either package's), read
    off its attributes: the input of ``encoded_hin_from_arrays``."""
    return {
        "name": hin.name,
        "node_types": list(hin.schema.node_types),
        "relations": {r: tuple(s) for r, s in hin.schema.relations.items()},
        "types": {
            t: (
                {"ids": list(ix.ids), "labels": list(ix.labels)}
                if ix.ids
                else {"size": ix.size}
            )
            for t, ix in hin.indices.items()
        },
        "blocks": {
            r: {
                "relationship": b.relationship,
                "src_type": b.src_type,
                "dst_type": b.dst_type,
                "rows": np.asarray(b.rows),
                "cols": np.asarray(b.cols),
                "shape": tuple(b.shape),
            }
            for r, b in hin.blocks.items()
        },
    }


def port_hin(hin):
    """The port's EncodedHIN for a JAX-package EncodedHIN."""
    return encoded_hin_from_arrays(hin_state(hin))


def assert_hin_equal(a, b) -> None:
    """Same schema, index spaces and blocks (dtypes included)."""
    assert a.name == b.name
    assert tuple(a.schema.node_types) == tuple(b.schema.node_types)
    assert dict(a.schema.relations) == dict(b.schema.relations)
    assert list(a.indices) == list(b.indices)
    for t in a.indices:
        ia, ib = a.indices[t], b.indices[t]
        assert ia.size == ib.size, t
        assert tuple(ia.ids) == tuple(ib.ids), t
        assert tuple(ia.labels) == tuple(ib.labels), t
        assert dict(ia.index_of) == dict(ib.index_of), t
    assert list(a.blocks) == list(b.blocks)
    for r in a.blocks:
        ba, bb = a.blocks[r], b.blocks[r]
        assert (ba.relationship, ba.src_type, ba.dst_type, tuple(ba.shape)) == (
            bb.relationship, bb.src_type, bb.dst_type, tuple(bb.shape)
        ), r
        assert ba.rows.dtype == bb.rows.dtype and ba.cols.dtype == bb.cols.dtype
        np.testing.assert_array_equal(ba.rows, bb.rows)
        np.testing.assert_array_equal(ba.cols, bb.cols)


# -- kernel parity inputs (tests/test_torch_kernels*.py) ---------------------


def _factor(hin, spec):
    from distributed_pathsim_tpu.ops import metapath as jmeta
    from distributed_pathsim_tpu.ops import planner as jplan

    c = jplan.dense_half(hin, jmeta.compile_metapath(spec, hin.schema),
                         dtype=np.float64)
    return c.astype(np.float32), (c @ c.sum(0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _kernel_case(case):
    from distributed_pathsim_tpu.data import synthetic as jsyn

    if case == "narrow":
        # APVPA, N = 1500 (not a tile multiple; n_j = 2 column stripes of
        # the Pallas kernel), V = 40
        return _factor(jsyn.synthetic_hin(1500, 2250, 40, seed=5), "APVPA")
    if case == "wide":
        # APA, V = #papers = 1100 > 512: the K-tiled Pallas variants run
        return _factor(jsyn.synthetic_hin(700, 1100, 8, seed=6), "APA")
    if case == "ties":
        # tie-heavy rows (40 distinct row patterns repeated) and
        # zero-degree targets, N = 1100 > 1024
        rng = np.random.default_rng(8)
        base = rng.integers(0, 3, size=(40, 24))
        c = base[rng.integers(0, 40, size=1100)].astype(np.float32)
        c[rng.integers(0, 1100, size=90)] = 0.0
        return c, (c.astype(np.float64) @ c.sum(0)).astype(np.float32)
    if case == "multilimb":
        # 1-limb rows of 0..3, and rows with one 2- or 3-limb entry each in
        # its own column, where every other row holds at most 1: path
        # counts between distinct rows stay below 2^24 (a 3-limb row's own
        # count does not)
        rng = np.random.default_rng(5)
        n, v = 300, 40
        c = rng.integers(0, 4, (n, v)).astype(np.float64)
        c[rng.random((n, v)) < 0.5] = 0
        cols = rng.choice(v, 6, replace=False)
        c[:, cols] = np.minimum(c[:, cols], 1)
        for i, (r, col) in enumerate(zip(rng.choice(n, 6, replace=False),
                                         cols)):
            c[r, col] = 65536 + 31 * i if i < 2 else 300 + 100 * i
        m = c @ c.T
        np.fill_diagonal(m, 0)
        assert m.max() < 2**24
        return c.astype(np.float32), (c @ c.sum(0)).astype(np.float32)
    raise KeyError(case)


def kernel_case(case):
    """(C, d) of one kernel parity case: ``narrow``, ``wide``, ``ties``
    or ``multilimb``. Built once per process; each caller gets its own
    copy."""
    return tuple(a.copy() for a in _kernel_case(case))


def assert_topk_matches_pallas(c, d, k, mask_self):
    """The plain two-pass top-k and its dispatching wrapper (CPU tensors)
    equal the Pallas kernel in interpret mode, values and indices."""
    import jax.numpy as jnp
    import torch

    from distributed_pathsim_tpu.ops import pallas_kernels as pk
    from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

    jv, ji = pk.fused_topk_twopass(jnp.asarray(c), jnp.asarray(d), k=k,
                                   mask_self=mask_self, interpret=True)
    tc, td = factor_from_arrays(c, d, "cpu")
    tv, ti = ck.fused_topk_twopass_plain(tc, td, k=k, mask_self=mask_self)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    # the dispatching wrapper takes the plain version for CPU tensors
    wv, wi = ck.fused_topk_twopass(tc, td, k=k, mask_self=mask_self)
    assert torch.equal(wv, tv) and torch.equal(wi, ti)


# -- backend parity (tests/test_torch_backend*.py) ---------------------------


def backend_graphs():
    """One synthetic graph in both packages' encodings."""
    from distributed_pathsim_tpu.data import synthetic as jsyn

    jhin = jsyn.synthetic_hin(400, 600, 16, n_topics=6, seed=13)
    return jhin, port_hin(jhin)


def backend_set(graphs, spec):
    """(JAX ``jax``, JAX ``numpy``, port ``torch`` on the CPU, port
    ``numpy``) backends for one metapath over ``backend_graphs()``."""
    from distributed_pathsim_tpu.backends.base import create_backend as jcreate
    from distributed_pathsim_tpu.ops import metapath as jmeta
    from distributed_pathsim_tpu_torch.backends.base import (
        create_backend as tcreate,
    )
    from distributed_pathsim_tpu_torch.ops import metapath as tmeta

    jhin, thin = graphs
    jmp = jmeta.compile_metapath(spec, jhin.schema)
    tmp = tmeta.compile_metapath(spec, thin.schema)
    return (
        jcreate("jax", jhin, jmp),
        jcreate("numpy", jhin, jmp),
        tcreate("torch", thin, tmp, device="cpu"),
        tcreate("numpy", thin, tmp),
    )


# -- CLI parity (tests/test_torch_cli*.py) -----------------------------------


def write_cli_gexf(path) -> str:
    """The synthetic GEXF both CLIs read."""
    from distributed_pathsim_tpu_torch.data.synthetic import (
        synthetic_hin,
        write_gexf,
    )

    write_gexf(
        synthetic_hin(350, 520, 14, n_topics=5, seed=21, materialize_ids=True),
        str(path),
    )
    return str(path)


def run_both_clis(gexf, extra, capsys, out_j=(), out_t=()):
    """Run both CLIs with ``extra`` (+ each side's own output flags);
    returns ((rc, stdout, stderr) of jax, (rc, stdout, stderr) of torch)."""
    from distributed_pathsim_tpu.cli import main as jax_main
    from distributed_pathsim_tpu_torch.cli import main as torch_main

    capsys.readouterr()
    rc_j = jax_main(["--dataset", gexf, "--backend", "jax", "--platform",
                     "cpu", "--loader", "python", *extra, *out_j])
    j = capsys.readouterr()
    rc_t = torch_main(["--dataset", gexf, "--backend", "torch",
                       "--platform", "cpu", *extra, *out_t])
    t = capsys.readouterr()
    return (rc_j, j.out, j.err), (rc_t, t.out, t.err)


# -- streaming tier (tests/test_torch_sparse_tier*.py, dense dispatch) ------


def overflow_hins(counts):
    """(JAX-package HIN, port HIN) whose APVPA half factor equals
    ``counts`` ([A, V] integer paper multiplicities: each (a, v) pair
    gets its own single-author, single-venue papers) — counts past 2^24
    without a large graph."""
    from distributed_pathsim_tpu.data.encode import (
        AdjacencyBlock,
        EncodedHIN,
        TypeIndex,
    )
    from distributed_pathsim_tpu.data.schema import HINSchema

    counts = np.asarray(counts, dtype=np.int64)
    n_a, n_v = counts.shape
    schema = HINSchema(
        node_types=("author", "paper", "venue"),
        relations={"author_of": ("author", "paper"),
                   "submit_at": ("paper", "venue")},
    )

    def _idx(t, size):
        return TypeIndex(node_type=t, ids=(), labels=(), index_of={},
                         size_override=size)

    a_i, v_i = np.nonzero(counts)
    reps = counts[a_i, v_i]
    n_p = int(reps.sum())
    papers = np.arange(n_p, dtype=np.int32)
    jhin = EncodedHIN(
        schema=schema,
        indices={"author": _idx("author", n_a), "paper": _idx("paper", n_p),
                 "venue": _idx("venue", n_v)},
        blocks={
            "author_of": AdjacencyBlock(
                relationship="author_of", src_type="author", dst_type="paper",
                rows=np.repeat(a_i, reps).astype(np.int32), cols=papers,
                shape=(n_a, n_p),
            ),
            "submit_at": AdjacencyBlock(
                relationship="submit_at", src_type="paper", dst_type="venue",
                rows=papers, cols=np.repeat(v_i, reps).astype(np.int32),
                shape=(n_p, n_v),
            ),
        },
    )
    return jhin, port_hin(jhin)


def f64_oracle_topk(c, k):
    """Exact f64 scores of the factor ``c`` and their (−score, ascending
    column) top-k, self pairs excluded: (values, columns, row sums)."""
    c = np.asarray(c, dtype=np.float64)
    m = c @ c.T
    d = m.sum(axis=1)
    den = d[:, None] + d[None, :]
    s = np.where(den > 0, 2.0 * m / np.where(den > 0, den, 1.0), 0.0)
    np.fill_diagonal(s, -np.inf)
    cols = np.broadcast_to(np.arange(c.shape[0]), s.shape)
    o = np.lexsort((cols, -s), axis=-1)[:, :k]
    return np.take_along_axis(s, o, axis=1), o, d


def metapaths(graphs, spec="APVPA"):
    """The compiled metapath of ``spec`` in both packages."""
    from distributed_pathsim_tpu.ops import metapath as jmeta
    from distributed_pathsim_tpu_torch.ops import metapath as tmeta

    jhin, thin = graphs
    return (jmeta.compile_metapath(spec, jhin.schema),
            tmeta.compile_metapath(spec, thin.schema))


# -- delta ingestion and serving (tests/test_torch_delta*.py, serving) -------


def delta_graphs(headroom=0.3, n_authors=96, n_papers=150, n_venues=7,
                 seed=3):
    """(JAX-package HIN, port HIN): one synthetic graph with materialized
    ids (node appends take the id path, as on the wire), each side given
    its own package's capacity headroom."""
    from distributed_pathsim_tpu.data import delta as jdl
    from distributed_pathsim_tpu.data import synthetic as jsyn
    from distributed_pathsim_tpu_torch.data import delta as tdl

    raw = jsyn.synthetic_hin(n_authors, n_papers, n_venues, seed=seed,
                             materialize_ids=True)
    return jdl.with_headroom(raw, headroom), tdl.with_headroom(
        port_hin(raw), headroom)


def random_delta_spec(hin, rng, n_changes=12, append=False,
                      rels=("author_of", "submit_at")):
    """A random delta as plain data: adds and removes over each of
    ``rels`` (both half-chain blocks of APVPA by default, so both
    product-rule terms run), optionally one appended author wired in by
    an added edge. ``{"edges": [(rel, add, remove)], "nodes": [(type,
    ids)]}``; build it in either package with :func:`make_delta`."""
    edges = []
    per_rel = max(n_changes // 2, 2)
    for rel in rels:
        b = hin.blocks[rel]
        n_src = hin.type_size(b.src_type)
        n_dst = hin.type_size(b.dst_type)
        n_rem = per_rel // 2
        rem_i = rng.choice(b.nnz, size=n_rem, replace=False)
        removes = np.stack([b.rows[rem_i], b.cols[rem_i]], axis=1)
        existing = set(zip(b.rows.tolist(), b.cols.tolist()))
        adds = []
        while len(adds) < per_rel - n_rem:
            e = (int(rng.integers(0, n_src)), int(rng.integers(0, n_dst)))
            if e not in existing:
                existing.add(e)
                adds.append(e)
        edges.append([rel, np.asarray(adds, dtype=np.int64).reshape(-1, 2),
                      removes.astype(np.int64)])
    nodes = []
    if append:
        n_auth = hin.type_size("author")
        nodes.append(("author", (f"author_{n_auth}",)))
        extra = [[n_auth, int(rng.integers(0, hin.type_size("paper")))]]
        edges[0][1] = np.concatenate([edges[0][1], extra]).astype(np.int64)
    return {"edges": [tuple(e) for e in edges], "nodes": nodes}


def make_delta(dl, spec):
    """A ``DeltaBatch`` of the package whose ``data.delta`` module is
    ``dl``, from :func:`random_delta_spec`'s plain data."""
    return dl.DeltaBatch(
        edges=tuple(dl.edge_delta(rel, add=add, remove=rem)
                    for rel, add, rem in spec["edges"]),
        nodes=tuple(dl.NodeAppend(node_type=t, ids=tuple(ids))
                    for t, ids in spec["nodes"]),
    )


def assert_coo_equal(a, b) -> None:
    """Two COO factors (either package's) with equal shape, coordinates
    and weights, in order."""
    assert tuple(a.shape) == tuple(b.shape)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.weights, b.weights)


# -- the bench twins against the repository harness -------------------------


@contextlib.contextmanager
def untuned_packages():
    """Both packages untuned, so every knob resolves to its default
    whatever file ran before in the worker (the checked-in CPU table is
    fingerprinted for another jax)."""
    from distributed_pathsim_tpu.tuning import dispatch as jtuning
    from distributed_pathsim_tpu_torch import tuning

    prev_j, prev_t = jtuning._state.enabled, tuning.dispatch._state.enabled
    jtuning.set_enabled(False)
    tuning.set_enabled(False)
    try:
        yield
    finally:
        jtuning.set_enabled(prev_j)
        tuning.set_enabled(prev_t)


@pytest.fixture(autouse=True)
def untuned():
    """:func:`untuned_packages` around each test of a file that imports
    this fixture."""
    with untuned_packages():
        yield

REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_harness():
    """The repository's ``bench_serving.py`` (the JAX package's load
    generator), imported from the repository root."""
    import sys

    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import bench_serving

    return bench_serving


def key_tree(d, prefix="", leaves=("buckets",)):
    """Every key path of a bench result. A key in ``leaves`` is a leaf:
    its keys are decided by the clock (a ``buckets`` histogram's batch
    sizes, the ann regime's ``speedups``, which name the sweep points
    that met the p99 SLO)."""
    out = set()
    if isinstance(d, dict):
        for key, value in d.items():
            path = f"{prefix}/{key}"
            out.add(path)
            if key not in leaves:
                out |= key_tree(value, path, leaves)
    return out


def assert_deterministic(checks, regime, exempt=()):
    """Every check of ``regime`` true but the clock's (the twin's
    ``CLOCK_CHECKS``) and those named in ``exempt``."""
    from distributed_pathsim_tpu_torch import bench_serving as bs

    clock = bs.CLOCK_CHECKS.get(regime, ())
    assert set(clock) | set(exempt) <= set(checks)
    failed = [name for name, ok in checks.items()
              if name not in clock and name not in exempt and not ok]
    assert not failed, checks
