"""Port parity: NeuralPathSim (models/neural.py) against the JAX package's
on the CPU, on tests/test_neural.py's graph.

- The host numpy parts — features, target scale, quadrature, gates,
  the CSR/CSC pools, ``pair_scores``, ``sample_batch`` (with and without
  a hard pool, under an 8-shard virtual mesh), the struct index, the
  exact rerank and the mined candidate lists — are bit-identical
  (``assert_array_equal``).
- Training goes through the same initial weights (the JAX tower's
  parameters carried into the port with ``params_from_flax``) and the
  same batches: 5 steps agree to ``rtol=1e-4`` (losses) and
  ``atol=1e-5`` (embeddings), the tolerances of JAX's own
  sharded-vs-single test; the port's sharded step equals its single one
  at the same tolerances.
- The port's own training (its own initial draws) meets the JAX
  package's statistical gates with their thresholds, and it refuses
  what the JAX package refuses, with the same messages.
"""

import jax
import numpy as np
import pytest

from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.models.neural import NeuralPathSim as JNeural
from distributed_pathsim_tpu.parallel.mesh import make_mesh as jmesh
from distributed_pathsim_tpu_torch.models.neural import (
    NeuralPathSim,
    params_from_flax,
)
from distributed_pathsim_tpu_torch.parallel.mesh import make_mesh
from torch_port_util import port_hin


@pytest.fixture(scope="module")
def hins():
    jhin = jsyn(200, 300, 16, seed=5)
    return jhin, port_hin(jhin)


def _pair(hins, mesh=None, **kw):
    """(JAX, port) models with the same arguments; the port's tower starts
    from the JAX tower's initial weights."""
    jhin, thin = hins
    j = JNeural(jhin, "APVPA", mesh=jmesh(mesh) if mesh else None, **kw)
    t = NeuralPathSim(thin, "APVPA", device="cpu",
                      mesh=make_mesh(mesh, platform="cpu") if mesh else None,
                      **kw)
    params_from_flax(jax.tree_util.tree_map(np.asarray, j.state.params),
                     t.model)
    return j, t


def test_host_arrays_equal_jax(hins):
    for variant in ("rowsum", "diagonal"):
        j, t = _pair(hins, dim=8, hidden=16, seed=4, variant=variant)
        for name in ("features", "_c64", "_d", "_quad_t", "_quad_w",
                     "_gates", "_row_ptr", "_row_cols", "_nz_rows",
                     "_col_ptr"):
            np.testing.assert_array_equal(getattr(t, name),
                                          getattr(j, name), err_msg=name)
        assert t.target_scale == j.target_scale
        assert (t.n, t.v, t._config) == (j.n, j.v, j._config)
        rng = np.random.default_rng(3)
        i, k = rng.integers(0, 200, 300), rng.integers(0, 200, 300)
        np.testing.assert_array_equal(t.pair_scores(i, k),
                                      j.pair_scores(i, k))
        np.testing.assert_array_equal(t.struct_embeddings(),
                                      j.struct_embeddings())
        np.testing.assert_array_equal(t.exact_scores(), j.exact_scores())
        # the tower's flax-layout shapes, and the carried weights embed
        # the corpus as JAX does
        for name, p in t.model.named_parameters():
            layer, leaf = name.split(".")
            assert tuple(p.shape) == j.state.params["params"][layer][
                leaf].shape
        np.testing.assert_allclose(t.embeddings(), j.embeddings(),
                                   atol=1e-5)


def test_sample_batch_equal_jax(hins):
    """Same generator state → the same batch, with and without a pool,
    single-device and under an 8-shard mesh (round-up and, with a pool,
    the permutation consume the rng as JAX's do)."""
    for mesh in (None, 8):
        j, t = _pair(hins, mesh=mesh, dim=8, hidden=16, seed=0)
        for pool in (False, True):
            if pool:
                src, cand = j.mine_hard_candidates(12, k=8, seed=1)
                j.set_hard_pool(src, cand)
                t.set_hard_pool(src, cand)
            for batch in (32, 256, 512):
                got = t.sample_batch(batch, np.random.default_rng(batch))
                want = j.sample_batch(batch, np.random.default_rng(batch))
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_struct_queries_and_rerank_equal_jax(hins):
    j, t = _pair(hins, dim=8, hidden=16, seed=0)
    for row in (0, 7, 113, 199):
        np.testing.assert_array_equal(t.struct_sims(row), j.struct_sims(row))
        assert t.topk_struct(row, k=7) == j.topk_struct(row, k=7)
        assert t.topk_rerank(row, k=6, candidates=40) == \
            j.topk_rerank(row, k=6, candidates=40)
    # the learned prefilter over enough candidates to cover: the exact
    # rerank makes the answer independent of f32 rounding in the tower
    for row in (3, 50):
        assert t.topk_rerank(row, k=5, candidates=199, index="learned") == \
            j.topk_rerank(row, k=5, candidates=199, index="learned")


def test_mined_candidates_equal_jax(hins):
    j, t = _pair(hins, dim=8, hidden=16, seed=0)
    for kw in ({"n_sources": 16, "k": 8, "seed": 3, "chunk": 5},
               {"n_sources": 40, "k": 4, "seed": 0,
                "exclude": np.arange(0, 200, 2)},
               {"n_sources": 300, "k": 250, "seed": 2}):
        got = t.mine_hard_candidates(**kw)
        want = j.mine_hard_candidates(**kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_five_steps_from_carried_weights_match_jax(hins):
    j, t = _pair(hins, dim=16, hidden=32, lr=3e-3, seed=3)
    src, cand = j.mine_hard_candidates(24, k=8, seed=2)
    for m in (j, t):
        m.set_hard_pool(src, cand)
    lj = j.train(steps=5, batch_size=256, seed=7)
    lt = t.train(steps=5, batch_size=256, seed=7)
    assert isinstance(lt, list) and all(isinstance(x, float) for x in lt)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    np.testing.assert_allclose(t.embeddings(), j.embeddings(), atol=1e-5)
    assert t.state.step == j.state.step == 5
    assert int(t.state.opt_state.count) == 5
    # the embedding cache: read-only, dropped by training
    e = t.embeddings()
    assert t.embeddings() is e
    with pytest.raises(ValueError):
        e[0, 0] = 9.0
    t.train(steps=1, batch_size=64, seed=0)
    assert t.embeddings() is not e and not np.allclose(t.embeddings(), e)


def test_sharded_step_matches_single_device(hins):
    """tests/test_neural.py:59 on the port: the 8-shard step (contiguous
    source blocks, psum of the gradients before the clip) equals the
    single-device step."""
    thin = hins[1]
    single = NeuralPathSim(thin, "APVPA", dim=16, hidden=32, seed=3,
                           device="cpu")
    sharded = NeuralPathSim(thin, "APVPA", dim=16, hidden=32, seed=3,
                            mesh=make_mesh(8, platform="cpu"))
    l1 = single.train(steps=5, batch_size=256, seed=7)
    l2 = sharded.train(steps=5, batch_size=256, seed=7)
    np.testing.assert_allclose(l1, l2, rtol=1e-4)
    np.testing.assert_allclose(single.embeddings(), sharded.embeddings(),
                               atol=1e-5)


def test_pool_rows_shuffled_and_small_batch_rounds_up_under_mesh(hins):
    """tests/test_neural.py:201 and :225 on the port."""
    thin = hins[1]
    model = NeuralPathSim(thin, "APVPA", dim=8, hidden=16, seed=0,
                          mesh=make_mesh(8, platform="cpu"))
    pool_src = np.arange(190, 200)
    model.set_hard_pool(pool_src, np.tile(np.arange(4), (10, 1)))
    b = 16  # batch_size 512 / SLATE 32
    hard_rows = int(round(b * model.HARD_FRAC))
    src, cand, tgt = model.sample_batch(512, np.random.default_rng(0))
    assert src.shape[0] == b and len(cand) == len(src) == len(tgt)
    in_pool = np.isin(src, pool_src)
    assert in_pool.sum() >= hard_rows
    assert not (in_pool[:hard_rows].all() and not in_pool[hard_rows:].any())
    model.clear_hard_pool()
    losses = model.train(steps=2, batch_size=64, seed=1)
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_training_reduces_loss_with_and_without_a_pool(hins):
    """tests/test_neural.py:17 and :340, thresholds unchanged."""
    thin = hins[1]
    model = NeuralPathSim(thin, "APVPA", dim=32, hidden=64, lr=3e-3, seed=0,
                          device="cpu")
    losses = model.train(steps=60, batch_size=256, seed=0)
    assert losses[-1] < losses[0] * 0.5
    assert model.embeddings().shape == (200, 32)
    model = NeuralPathSim(thin, "APVPA", dim=32, hidden=64, lr=3e-3, seed=0,
                          device="cpu")
    src_pool, cand_pool = model.mine_hard_candidates(64, k=16, seed=2)
    model.set_hard_pool(src_pool, cand_pool)
    losses = model.train(steps=60, batch_size=256, seed=0)
    assert losses[-1] < losses[0] * 0.5
    model.clear_hard_pool()
    assert model._hard_src is None


def test_predictions_correlate_with_exact(hins):
    """tests/test_neural.py:25, thresholds unchanged: correlation on
    pairs with nonzero exact score and top-k ranking recall."""
    model = NeuralPathSim(hins[1], "APVPA", dim=32, hidden=64, lr=3e-3,
                          seed=0, device="cpu")
    model.train(steps=600, batch_size=1024, seed=1)
    exact = model.exact_scores()
    rng = np.random.default_rng(2)
    ii, jj = np.nonzero(exact > 0)
    sel = rng.integers(0, len(ii), size=500)
    corr = np.corrcoef(
        model.predict_pairs(ii[sel], jj[sel]), exact[ii[sel], jj[sel]]
    )[0, 1]
    assert corr > 0.8, corr
    e = model.embeddings()
    sims = e @ e.T
    masked = exact.copy()
    np.fill_diagonal(masked, -np.inf)
    np.fill_diagonal(sims, -np.inf)
    recalls = []
    for i in range(exact.shape[0]):
        npos = int((masked[i] > 0).sum())
        if npos == 0:
            continue
        k = min(10, npos)
        top_exact = set(np.argsort(-masked[i])[:k].tolist())
        top_pred = set(np.argsort(-sims[i])[:k].tolist())
        recalls.append(len(top_exact & top_pred) / k)
    assert np.mean(recalls) > 0.5, np.mean(recalls)


def test_refusals_match_jax(hins, monkeypatch):
    """tests/test_neural.py:72, :87, :194, :263, :308 and :350: the same
    errors with the same messages."""
    jhin, thin = hins
    j, t = _pair(hins, dim=8, hidden=16, seed=0)

    def same(fn_port, fn_jax, exc):
        with pytest.raises(exc) as ours:
            fn_port()
        with pytest.raises(exc) as theirs:
            fn_jax()
        assert str(ours.value) == str(theirs.value)
        return str(ours.value)

    assert "symmetric" in same(
        lambda: NeuralPathSim(thin, "APV", device="cpu"),
        lambda: JNeural(jhin, "APV"), ValueError)
    assert "unknown PathSim variant" in same(
        lambda: NeuralPathSim(thin, "APVPA", variant="bogus", device="cpu"),
        lambda: JNeural(jhin, "APVPA", variant="bogus"), ValueError)
    assert "unknown index" in same(
        lambda: t.topk_rerank(0, index="bogus"),
        lambda: j.topk_rerank(0, index="bogus"), ValueError)
    for src, cand in ((np.arange(4), np.zeros((3, 2), int)),
                      (np.array([5, 1000]), np.zeros((2, 3), int)),
                      (np.array([5, 6]), np.array([[0, -1, 2]] * 2)),
                      (np.array([5.0, 6.0]), np.zeros((2, 3), int))):
        assert "hard pool" in same(lambda: t.set_hard_pool(src, cand),
                                   lambda: j.set_hard_pool(src, cand),
                                   ValueError)
    monkeypatch.setattr(NeuralPathSim, "_DENSE_SCORES_MAX_ENTRIES", 100)
    monkeypatch.setattr(JNeural, "_DENSE_SCORES_MAX_ENTRIES", 100)
    assert "pair_scores" in same(t.exact_scores, j.exact_scores,
                                 MemoryError)
