"""Port parity: delta ingestion's host algebra against the JAX package —
the product-rule ΔC, the row-granular patch, the affected-rows bound,
``fold_blocks``, ``plan_delta``'s decisions, the fingerprints (byte for
byte: a router fences replicas on them) and the malformed-delta
messages, on the same numpy-seeded graphs and deltas. Zero tolerance:
every array is integer-valued."""

import numpy as np
import pytest

from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.ops import planner as jplan
from distributed_pathsim_tpu.ops import sparse as jsp
from distributed_pathsim_tpu.serving import cache as jcache
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops import metapath as tmeta
from distributed_pathsim_tpu_torch.ops import planner as tplan
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from distributed_pathsim_tpu_torch.serving import cache as tcache
from torch_port_util import (
    assert_coo_equal,
    assert_hin_equal,
    delta_graphs,
    make_delta,
    port_hin,
    random_delta_spec,
)


def _random_coo(sp, rng, shape, nnz, signed=False):
    rows = rng.integers(0, shape[0], nnz)
    cols = rng.integers(0, shape[1], nnz)
    w = (rng.choice([-1.0, 1.0], nnz) if signed
         else np.ones(nnz, dtype=np.float64))
    return sp.COOMatrix(rows=rows.astype(np.int64), cols=cols.astype(np.int64),
                        weights=w, shape=shape)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_algebra_and_fold_blocks_match_jax(seed):
    """coo_delta_fold (1-, 2- and 3-block halves: the direct, product-
    rule and refold branches), coo_apply_delta, coo_nonzero,
    affected_source_rows and fold_blocks, on random chains."""
    rng = np.random.default_rng(seed)
    dims = [int(x) for x in rng.integers(5, 30, size=4)]
    for n_blocks in (1, 2, 3):
        shapes = [(dims[i], dims[i + 1]) for i in range(n_blocks)]
        ins = [(rng.integers(0, 2**31), s) for s in shapes]
        per = {}
        for name, sp in (("jax", jsp), ("torch", tsp)):
            blocks = [
                _random_coo(sp, np.random.default_rng(int(g)), s, 3 * s[0])
                .summed() for g, s in ins
            ]
            deltas = [
                _random_coo(sp, np.random.default_rng(int(g) + 1), s, 4,
                            signed=True) for g, s in ins
            ]
            plan = jplan if name == "jax" else tplan
            c_old = plan.fold_blocks(blocks)
            dc = sp.coo_delta_fold(blocks, deltas)
            c_new = sp.coo_apply_delta(c_old.summed(), dc)
            aff = sp.affected_source_rows(c_old, c_new, dc,
                                          n_logical=shapes[0][0] - 1)
            per[name] = (c_old, dc, c_new, sp.coo_nonzero(c_new), aff)
        for a, b in zip(per["jax"][:4], per["torch"][:4]):
            assert_coo_equal(a, b)
        np.testing.assert_array_equal(per["jax"][4], per["torch"][4])


@pytest.mark.parametrize("spec", ["APVPA", "APA", "APVPVPA"])
def test_plan_delta_chain_matches_jax(spec):
    """Three successive plans (edge adds and removes on both half blocks,
    an author appended in the second): same verdict, ΔC, patched factor,
    affected rows, chained fingerprint and new graph."""
    jhin, thin = delta_graphs()
    jmp = jmeta.compile_metapath(spec, jhin.schema)
    tmp = tmeta.compile_metapath(spec, thin.schema)
    rng = np.random.default_rng(11)
    for step in range(3):
        d = random_delta_spec(jhin, rng, n_changes=10, append=step == 1)
        jp = jdl.plan_delta(jhin, make_delta(jdl, d), jmp,
                            max_delta_fraction=0.5)
        tp = tdl.plan_delta(thin, make_delta(tdl, d), tmp,
                            max_delta_fraction=0.5)
        assert (tp.fallback, tp.reason) == (jp.fallback, jp.reason) == (
            False, None)
        assert tp.n_edge_changes == jp.n_edge_changes
        assert tp.fingerprint == jp.fingerprint
        assert tp.fingerprint.startswith("~")
        assert tcache.graph_fingerprint(tp.hin_new) == tp.fingerprint
        for a, b in ((jp.delta_c, tp.delta_c), (jp.half_old, tp.half_old),
                     (jp.half_new, tp.half_new)):
            assert_coo_equal(a, b)
        np.testing.assert_array_equal(tp.affected_rows, jp.affected_rows)
        assert_hin_equal(jp.hin_new, tp.hin_new)
        jhin, thin = jp.hin_new, tp.hin_new


def test_fingerprints_and_headroom_match_jax():
    """graph_fingerprint byte for byte (raw, padded, round-tripped),
    chain_fingerprint, delta digests, and delta_from_records."""
    from distributed_pathsim_tpu.data import synthetic as jsyn

    raw = jsyn.synthetic_hin(40, 70, 5, seed=1, materialize_ids=True)
    traw = port_hin(raw)
    assert tcache.graph_fingerprint(traw) == jcache.graph_fingerprint(raw)
    jpad = jdl.with_headroom(raw, 0.5)
    tpad = tdl.with_headroom(traw, 0.5)
    assert_hin_equal(jpad, tpad)
    assert tcache.graph_fingerprint(tpad) == jcache.graph_fingerprint(jpad)
    back = tdl.strip_headroom(tpad)
    assert_hin_equal(back, traw)
    assert tcache.graph_fingerprint(back) == tcache.graph_fingerprint(traw)
    assert tcache.chain_fingerprint("abc", "def") == jcache.chain_fingerprint(
        "abc", "def")
    d = random_delta_spec(raw, np.random.default_rng(5), append=True)
    assert make_delta(tdl, d).digest() == make_delta(jdl, d).digest()
    empty = tdl.DeltaBatch().digest()
    app = tdl.DeltaBatch(nodes=(tdl.NodeAppend(node_type="author",
                                               ids=("x",)),))
    assert app.digest() != empty and empty == jdl.DeltaBatch().digest()
    recs = dict(
        add_nodes=[{"type": "author", "id": "a_new", "label": "New"}],
        add_edges=[{"rel": "author_of", "src": "a_new", "dst": "paper_3"},
                   {"rel": "submit_at", "src_row": 5, "dst_row": 0}],
        remove_edges=[{"rel": "author_of", "src_row": int(raw.blocks[
            "author_of"].rows[0]), "dst_row": int(raw.blocks[
                "author_of"].cols[0])}],
    )
    jd = jdl.delta_from_records(jpad, **recs)
    td = tdl.delta_from_records(tpad, **recs)
    assert td.digest() == jd.digest()
    assert td.n_edge_changes == jd.n_edge_changes == 3
    assert td.n_node_appends == jd.n_node_appends == 1


def test_fallback_verdicts_match_jax():
    """Headroom overflow, an oversize delta and an asymmetric chain all
    say rebuild, with the JAX package's reasons."""
    jhin, thin = delta_graphs(headroom=0.0)  # the min_slots=8 reserve
    n = jhin.type_size("author")
    ids = tuple(f"author_{n + i}" for i in range(20))
    cases = []
    for dl, hin in ((jdl, jhin), (tdl, thin)):
        meta = jmeta if dl is jdl else tmeta
        mp = meta.compile_metapath("APVPA", hin.schema)
        apv = meta.compile_metapath("APV", hin.schema)
        app = dl.DeltaBatch(nodes=(dl.NodeAppend(node_type="author",
                                                 ids=ids),))
        over = dl.plan_delta(hin, app, mp)
        d = make_delta(dl, random_delta_spec(
            jhin, np.random.default_rng(0), n_changes=40))
        big = dl.plan_delta(hin, d, mp, max_delta_fraction=0.0001)
        asym = dl.plan_delta(hin, d, apv)
        cases.append([(p.fallback, p.reason, p.fingerprint,
                       p.hin_new.type_size("author"))
                      for p in (over, big, asym)])
    assert cases[0] == cases[1]
    (over, big, asym) = cases[1]
    assert over[0] and "headroom" in over[1] and over[3] == n + 20
    assert big[0] and "exceeds" in big[1]
    assert asym[0] and "not symmetric" in asym[1]


def test_malformed_deltas_rejected_like_jax():
    """Duplicate adds, phantom removes, range violations, unknown
    relationships and re-appended ids fail loudly, with the JAX
    package's exception type and message."""
    jhin, thin = delta_graphs()
    b = jhin.blocks["author_of"]
    e0 = [int(b.rows[0]), int(b.cols[0])]
    existing = set(zip(b.rows.tolist(), b.cols.tolist()))
    absent = next([a, 149] for a in range(96) if (a, 149) not in existing)
    specs = [
        {"edges": [("author_of", [e0], [])], "nodes": []},
        {"edges": [("author_of", [], [absent])], "nodes": []},
        {"edges": [("author_of", [absent, absent], [])], "nodes": []},
        {"edges": [("author_of", [[96, 0]], [])], "nodes": []},
        {"edges": [("author_of", [absent], [absent])], "nodes": []},
        {"edges": [("cites", [[0, 0]], [])], "nodes": []},
        {"edges": [], "nodes": [("author", ("author_0",))]},
        {"edges": [], "nodes": [("venue_x", ("v",))]},
    ]
    want = ["already exists", "nonexistent", "duplicate", "out of range",
            "both added and removed", "unknown relationship",
            "already present", "unknown node type"]
    for spec, fragment in zip(specs, want):
        errors = []
        for dl, hin in ((jdl, jhin), (tdl, thin)):
            with pytest.raises(ValueError) as exc:
                dl.apply_delta(hin, make_delta(dl, spec))
            errors.append(str(exc.value))
        assert errors[0] == errors[1], spec
        assert fragment in errors[1], errors[1]


def test_coalesce_deltas_matches_jax_and_sequential():
    """Folding a window of deltas gives the JAX package's batch and the
    same graph as applying them one by one (add-then-remove cancels)."""
    jhin, thin = delta_graphs()
    rng = np.random.default_rng(4)
    d1 = random_delta_spec(jhin, rng, n_changes=8, append=True)
    added = d1["edges"][0][1][:1]
    d2 = {"edges": [("author_of", [], added)], "nodes": []}
    d3 = random_delta_spec(jdl.apply_delta(
        jdl.apply_delta(jhin, make_delta(jdl, d1))[0],
        make_delta(jdl, d2))[0], rng, n_changes=6)
    windows = [[make_delta(dl, d) for d in (d1, d2, d3)] for dl in (jdl, tdl)]
    jc = jdl.coalesce_deltas(windows[0])
    tc = tdl.coalesce_deltas(windows[1])
    assert tc.digest() == jc.digest()
    seq = thin
    for d in windows[1]:
        seq, _ = tdl.apply_delta(seq, d)
    once, _ = tdl.apply_delta(thin, tc)
    for rel in seq.blocks:
        a, b = seq.blocks[rel], once.blocks[rel]
        key = lambda blk: sorted(zip(blk.rows.tolist(), blk.cols.tolist()))  # noqa: E731
        assert key(a) == key(b), rel
    with pytest.raises(tdl.NotCoalescable):
        tdl.coalesce_deltas([windows[1][0], windows[1][0]])
