"""Port parity: the workload-level sub-chain memo (``ops/planner.py``
``SubchainCache``) against the JAX package's, on the CPU. Both packages
fold the same numpy-seeded synthetic graph with topics; every comparison
has zero tolerance: warm folds equal cold ones and the JAX package's,
sub-chains are shared across metapaths, random delta sequences never
serve a stale entry, invalidation drops only the changed factors'
entries, the LRU evicts under its budget and skips oversized entries,
and the hit / miss / eviction accounting over one sequence of folds
equals the JAX memo's."""

import numpy as np
import pytest

from distributed_pathsim_tpu import tuning as jtuning
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.ops import planner as jplan
from distributed_pathsim_tpu.ops import sparse as jsp
from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops import planner
from distributed_pathsim_tpu_torch.ops import sparse as sp
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from torch_port_util import assert_coo_equal, make_delta, port_hin

SPECS = ("APVPA", "APTPA", "APA", "APVPTPA")


def _graphs(seed, n_authors=40, n_papers=70, n_venues=6, n_topics=5):
    jhin = jsyn.synthetic_hin(n_authors, n_papers, n_venues,
                              n_topics=n_topics, topics_per_paper=1.4,
                              seed=seed)
    return jhin, port_hin(jhin)


def _coo_equal(a, b):
    assert_coo_equal(a.summed(), b.summed())


def test_memo_warm_equals_cold_and_shares_subchains():
    jhin, thin = _graphs(5)
    memo = planner.SubchainCache(64 << 20)
    apvpa = compile_metapath("APVPA", thin.schema)
    aptpa = compile_metapath("APTPA", thin.schema)
    cold = planner.fold_half(thin, apvpa)
    warm = planner.fold_half(thin, apvpa, memo=memo)
    _coo_equal(cold, warm)
    _coo_equal(warm, jplan.fold_half(
        jhin, jmeta.compile_metapath("APVPA", jhin.schema)))
    h0 = memo.hits
    # APTPA's half shares the oriented A·P factor with APVPA's
    _coo_equal(planner.fold_half(thin, aptpa),
               planner.fold_half(thin, aptpa, memo=memo))
    assert memo.hits > h0, "the shared A·P sub-chain should hit"
    h1 = memo.hits
    _coo_equal(planner.fold_half(thin, apvpa, memo=memo), cold)
    assert memo.hits > h1
    # the general fold of an asymmetric chain through the memo too
    gen = compile_metapath("APVPTPA", thin.schema)
    _coo_equal(planner.fold_general(thin, gen, memo=memo),
               jplan.fold_general(jhin, jmeta.compile_metapath(
                   "APVPTPA", jhin.schema)))


def test_memo_correct_across_random_delta_sequences():
    rng = np.random.default_rng(11)
    jhin, thin = _graphs(6)
    memo = planner.SubchainCache(64 << 20)
    jmemo = jplan.SubchainCache(64 << 20)
    mp = compile_metapath("APVPA", thin.schema)
    jmp = jmeta.compile_metapath("APVPA", jhin.schema)
    planner.fold_half(thin, mp, memo=memo)  # seed the memos
    jplan.fold_half(jhin, jmp, memo=jmemo)
    for step in range(4):
        blk = thin.blocks["author_of"]
        existing = set(zip(blk.rows.tolist(), blk.cols.tolist()))
        adds = []
        for a in rng.permutation(thin.type_size("author")):
            p = int(rng.integers(0, thin.type_size("paper")))
            if (int(a), p) not in existing:
                adds.append((int(a), p))
                break
        j = int(rng.integers(0, blk.rows.shape[0]))
        spec = {"edges": [("author_of", np.asarray(adds, dtype=np.int64),
                           np.asarray([[blk.rows[j], blk.cols[j]]],
                                      dtype=np.int64))], "nodes": []}
        thin, grew = tdl.apply_delta(thin, make_delta(tdl, spec))
        jhin, _ = jdl.apply_delta(jhin, make_delta(jdl, spec))
        assert not grew
        warm = planner.fold_half(thin, mp, memo=memo)
        _coo_equal(warm, planner.fold_half(thin, mp))
        _coo_equal(warm, jplan.fold_half(jhin, jmp, memo=jmemo))
    assert memo.stats() == jmemo.stats()


def test_memo_invalidation_drops_only_changed_factors():
    jhin, thin = _graphs(8)
    memo = planner.SubchainCache(64 << 20)
    jmemo = jplan.SubchainCache(64 << 20)
    for spec in ("APVPA", "APTPA"):
        planner.fold_half(thin, compile_metapath(spec, thin.schema),
                          memo=memo)
        jplan.fold_half(jhin, jmeta.compile_metapath(spec, jhin.schema),
                        memo=jmemo)
    before = memo.stats()["entries"]
    dropped = memo.invalidate_relationships({"submit_at"})
    # submit_at appears only in APVPA's sub-chains; the A·P leaf and
    # APTPA's has_topic sub-chains survive
    assert 0 < dropped < before
    assert dropped == jmemo.invalidate_relationships({"submit_at"})
    assert memo.stats()["entries"] == before - dropped
    assert memo.invalidate_relationships({"no_such_rel"}) == 0
    assert memo.stats() == jmemo.stats()
    # the survivors still hit, and the refold equals a cold one
    h0 = memo.hits
    mp = compile_metapath("APTPA", thin.schema)
    _coo_equal(planner.fold_half(thin, mp, memo=memo),
               planner.fold_half(thin, mp))
    assert memo.hits > h0


def test_memo_budget_evicts_lru_and_skips_oversized():
    def coo(mod, nnz):
        return mod.COOMatrix(
            rows=np.zeros(nnz, dtype=np.int64),
            cols=np.zeros(nnz, dtype=np.int64),
            weights=np.ones(nnz), shape=(4, 4),
        )

    memo = planner.SubchainCache(10_000)
    jmemo = jplan.SubchainCache(10_000)
    for i in range(8):  # 8 × 2.4 kB under a 10 kB budget: must evict
        memo.put((("r", False, f"fp{i}"),), coo(sp, 100))
        jmemo.put((("r", False, f"fp{i}"),), coo(jsp, 100))
    st = memo.stats()
    assert st["evictions"] > 0 and st["bytes"] <= 10_000
    assert st == jmemo.stats()
    # least recently used goes first: fp0 is gone, fp7 stays
    assert memo.get((("r", False, "fp0"),)) is None
    assert memo.get((("r", False, "fp7"),)) is not None
    # an entry bigger than half the budget is skipped outright
    memo.put((("r", False, "big"),), coo(sp, 1000))
    assert memo.get((("r", False, "big"),)) is None
    # a zero budget memoizes nothing
    off = planner.SubchainCache(0)
    off.put((("r", False, "x"),), coo(sp, 1))
    assert off.stats()["entries"] == 0


def test_memo_stats_equal_jax_over_one_sequence():
    """One sequence of folds, an invalidation and refolds over a budget
    small enough to evict: entries, bytes, hits, misses and evictions
    equal the JAX memo's after every step."""
    jhin, thin = _graphs(9, n_authors=60, n_papers=110, n_topics=7)
    memo = planner.SubchainCache(24_000)
    jmemo = jplan.SubchainCache(24_000)
    for step in ("fold", "fold", "invalidate", "fold"):
        if step == "invalidate":
            assert memo.invalidate_relationships(["has_topic"]) == \
                jmemo.invalidate_relationships(["has_topic"])
        else:
            for spec in SPECS:
                mp = compile_metapath(spec, thin.schema)
                jmp = jmeta.compile_metapath(spec, jhin.schema)
                fold, jfold = ((planner.fold_half, jplan.fold_half)
                               if mp.is_symmetric else
                               (planner.fold_general, jplan.fold_general))
                _coo_equal(fold(thin, mp, memo=memo),
                           jfold(jhin, jmp, memo=jmemo))
        assert memo.stats() == jmemo.stats(), step
    assert memo.stats()["evictions"] > 0 and memo.stats()["hits"] > 0


@pytest.fixture
def fresh_tuning():
    tuning.reset()
    jtuning.reset()
    yield
    tuning.reset()
    jtuning.reset()


def test_budget_knob_and_format_equal_jax(fresh_tuning):
    assert "plan_memo_budget_mb" in tuning.KNOBS
    for n in (None, 350, 1 << 20):
        assert tuning.make_key("plan_memo_budget_mb", "cpu", n=n) == \
            jtuning.make_key("plan_memo_budget_mb", "cpu", n=n)
        assert planner.default_memo_budget_bytes(n) == \
            jplan.default_memo_budget_bytes(n) == 64 << 20
    assert (tuning.KNOBS["plan_memo_budget_mb"].candidates({})
            == jtuning.KNOBS["plan_memo_budget_mb"].candidates({}))
    # packed entry layouts are held (tests/test_torch_packed_sparse.py);
    # an unknown one is refused by name
    assert planner.SubchainCache(1 << 20,
                                 factor_format="blocked").factor_format \
        == "blocked"
    with pytest.raises(ValueError, match="unknown factor format"):
        planner.SubchainCache(1 << 20, factor_format="csr")


@pytest.mark.parametrize("name", ["numpy", "torch", "torch-sparse"])
def test_backends_fold_through_the_memo(name):
    """A backend built with ``subchain_memo`` folds through it (a second
    backend over the same graph hits) and answers exactly as one built
    without it, and as the JAX package's numpy oracle."""
    from distributed_pathsim_tpu.backends.base import create_backend as jcb

    jhin, thin = _graphs(12, n_authors=50, n_papers=90, n_topics=6)
    opts = {} if name == "numpy" else {"device": "cpu"}
    memo = planner.SubchainCache(64 << 20)
    mp = compile_metapath("APTPA", thin.schema)
    a = create_backend(name, thin, mp, subchain_memo=memo, **opts)
    misses = memo.misses
    b = create_backend(name, thin, mp, subchain_memo=memo, **opts)
    assert memo.misses == misses and memo.hits > 0
    plain = create_backend(name, thin, mp, **opts)
    oracle = jcb("numpy", jhin, jmeta.compile_metapath("APTPA", jhin.schema))
    rows = np.arange(thin.type_size("author"))
    want = oracle.topk_rows(rows, 5)
    for got in (a.topk_rows(rows, 5), b.topk_rows(rows, 5),
                plain.topk_rows(rows, 5)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert a.options["subchain_memo"] is memo
