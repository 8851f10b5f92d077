"""Port parity: ``apply_delta`` on the port's backends. A patched backend
must equal a rebuild of the same logical graph bit for bit — counts,
walks, f64 scores, top-k values and tie order — and the JAX package's
patched backend, through delta sequences with node appends, an
add-then-remove round trip, headroom overflow and an asymmetric chain.
The torch backend runs on the CPU here (its kernels' plain versions);
``tests/test_torch_cuda_serving.py`` repeats the patch on the card."""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu_torch.backends.base import (
    DeltaUnsupported,
    create_backend as tcreate,
)
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops import metapath as tmeta
from torch_port_util import delta_graphs, make_delta, random_delta_spec

# port backend → (constructor options, the JAX backend it is held to)
PORT_BACKENDS = {
    "torch": ({"device": "cpu"}, "jax"),
    "torch-sparse": ({"device": "cpu", "tile_rows": 32}, "jax-sparse"),
    "numpy": ({}, "numpy"),
}


def _assert_backends_equal(a, b, n_rows):
    rows = np.arange(n_rows)
    np.testing.assert_array_equal(a.global_walks(), b.global_walks())
    np.testing.assert_array_equal(a.pairwise_rows(rows), b.pairwise_rows(rows))
    np.testing.assert_array_equal(a.scores_rows(rows), b.scores_rows(rows))
    av, ai = a.topk_rows(rows, k=6)
    bv, bi = b.topk_rows(rows, k=6)
    np.testing.assert_array_equal(av, bv)
    np.testing.assert_array_equal(ai, bi)


@pytest.mark.parametrize("name", sorted(PORT_BACKENDS))
def test_patched_equals_rebuilt_and_jax(name):
    """A random delta sequence (adds + removes on both half blocks every
    step, an author appended every other step) absorbed in place."""
    opts, jname = PORT_BACKENDS[name]
    jhin, thin = delta_graphs()
    jmp = jmeta.compile_metapath("APVPA", jhin.schema)
    tmp = tmeta.compile_metapath("APVPA", thin.schema)
    tb = tcreate(name, thin, tmp, **opts)
    jb = jcreate(jname, jhin, jmp)
    rng = np.random.default_rng(11)
    for step in range(4):
        d = random_delta_spec(jhin, rng, n_changes=12, append=step % 2 == 1)
        jp = jdl.plan_delta(jhin, make_delta(jdl, d), jmp,
                            max_delta_fraction=0.5)
        tp = tdl.plan_delta(thin, make_delta(tdl, d), tmp,
                            max_delta_fraction=0.5)
        assert not tp.fallback
        jb.apply_delta(jp)
        tb.apply_delta(tp)
        jhin, thin = jp.hin_new, tp.hin_new
        n = thin.type_size("author")
        assert tb.n_sources == n == jb.n_sources
        rebuilt = tcreate(name, thin, tmp, **opts)
        _assert_backends_equal(tb, rebuilt, n)
        _assert_backends_equal(tb, jb, n)
        if name == "torch":
            c, rs = tb._half()
            rc, rrs = rebuilt._half()
            assert torch.equal(c, rc) and torch.equal(rs, rrs)
            np.testing.assert_array_equal(c.numpy(), np.asarray(jb._half()[0]))
            for k in (5, 20):  # the rank-all dispatch: K1 / K4 plain
                tv, ti = tb.topk(k=k)
                rv, ri = rebuilt.topk(k=k)
                np.testing.assert_array_equal(tv, rv)
                np.testing.assert_array_equal(ti, ri)
            np.testing.assert_array_equal(tb.all_pairs_scores(),
                                          rebuilt.all_pairs_scores())


def test_add_then_remove_restores_every_backend():
    """The delta algebra has a true inverse on every port backend."""
    _, thin = delta_graphs()
    mp = tmeta.compile_metapath("APVPA", thin.schema)
    blk = thin.blocks["author_of"]
    existing = set(zip(blk.rows.tolist(), blk.cols.tolist()))
    adds = [[a, p] for a in range(10) for p in (147, 148, 149)
            if (a, p) not in existing][:3]
    rows = np.arange(thin.type_size("author"))
    for name, (opts, _) in sorted(PORT_BACKENDS.items()):
        b = tcreate(name, thin, mp, **opts)
        before = b.scores_rows(rows).copy()
        fwd = tdl.DeltaBatch(edges=(tdl.edge_delta("author_of", add=adds),))
        plan = tdl.plan_delta(thin, fwd, mp, max_delta_fraction=0.5)
        b.apply_delta(plan)
        assert not np.array_equal(b.scores_rows(rows), before), name
        rev = tdl.DeltaBatch(edges=(tdl.edge_delta("author_of",
                                                   remove=adds),))
        b.apply_delta(tdl.plan_delta(plan.hin_new, rev, mp,
                                     max_delta_fraction=0.5))
        np.testing.assert_array_equal(b.scores_rows(rows), before)


def test_fallback_plans_and_asymmetric_chains_are_refused():
    """A plan that says rebuild is refused by every backend (ValueError
    naming the rebuild); an asymmetric chain has no patch path
    (DeltaUnsupported), as in the JAX package."""
    _, thin = delta_graphs(headroom=0.0)
    mp = tmeta.compile_metapath("APVPA", thin.schema)
    n = thin.type_size("author")
    app = tdl.NodeAppend(node_type="author",
                         ids=tuple(f"author_{n + i}" for i in range(20)))
    plan = tdl.plan_delta(thin, tdl.DeltaBatch(nodes=(app,)), mp)
    assert plan.fallback and "headroom" in plan.reason
    for name, (opts, _) in sorted(PORT_BACKENDS.items()):
        with pytest.raises(ValueError, match="rebuild"):
            tcreate(name, thin, mp, **opts).apply_delta(plan)
    apv = tmeta.compile_metapath("APV", thin.schema)
    d = make_delta(tdl, random_delta_spec(thin, np.random.default_rng(2)))
    aplan = tdl.plan_delta(thin, d, apv)
    assert aplan.fallback
    forced = type(aplan)(
        delta=aplan.delta, hin_old=aplan.hin_old, hin_new=aplan.hin_new,
        fingerprint=aplan.fingerprint, n_edge_changes=aplan.n_edge_changes,
        fallback=False, delta_c=None, half_old=None, half_new=None,
        affected_rows=np.empty(0, dtype=np.int64),
    )
    for name in ("numpy", "torch"):
        opts = PORT_BACKENDS[name][0]
        with pytest.raises(DeltaUnsupported):
            tcreate(name, thin, apv, **opts).apply_delta(forced)


def test_torch_patch_drops_every_cache_derived_from_c():
    """The patch drops M, the host row sums and C's u8 limbs (the
    kernels would otherwise rank the pre-delta counts; on the CPU the
    limbs are None, so a stand-in marks the slot), pads ΔC's nnz to a
    power of two, and a fetch after it re-runs the exact-count guard."""
    from distributed_pathsim_tpu_torch.backends.torch_dense import (
        _pad_coo_bucket,
    )

    _, thin = delta_graphs()
    mp = tmeta.compile_metapath("APVPA", thin.schema)
    b = tcreate("torch", thin, mp, device="cpu")
    b.commuting_matrix()
    b.global_walks()
    b._limbs_cache = object()
    d = make_delta(tdl, random_delta_spec(thin, np.random.default_rng(9)))
    plan = tdl.plan_delta(thin, d, mp, max_delta_fraction=0.5)
    b.apply_delta(plan)
    assert b._limbs_cache is None and b._m is None and b._rowsums is None
    assert b._rowsums64 is None
    nnz = int(plan.delta_c.rows.shape[0])
    r, c, w = _pad_coo_bucket(plan.delta_c.rows, plan.delta_c.cols,
                              plan.delta_c.weights)
    assert r.shape[0] == max(8, 1 << (nnz - 1).bit_length()) >= nnz
    assert not w[nnz:].any() and not r[nnz:].any() and not c[nnz:].any()
    b.exact_counts = True
    b._half_cache[0][0, 0] = float(2**24)  # a count past the f32 guard
    b._half_cache = (b._half_cache[0], b._half_cache[0].sum(1) * 2**24)
    with pytest.raises(OverflowError):
        b._denominators("rowsum")
