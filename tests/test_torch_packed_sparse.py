"""Port parity: the packed arms of ``torch-sparse`` and its symmetric
half-sweep, against the JAX package's ``jax-sparse``, zero tolerance.

- ``factor_format="blocked" | "bitpacked"``: rank-all values and indices
  equal to jax-sparse's with the same format and to the port's COO run,
  in each row-tile arm (K3's plain version, the scanned fold, the
  per-tile fold); ``factor_info`` and the checkpoint identity equal to
  the JAX package's;
- ``topk_scores(symmetric=True)``: equal to the full sweep and to the
  JAX package's symmetric sweep, in exact-rescore mode too; a crash
  mid-sweep resumes from its ``sym_partials`` snapshot with the same
  arrays; a stale snapshot is dropped on resume; symmetric and full
  checkpoints never mix;
- the packed sub-chain memo charges packed bytes (the JAX memo's bytes)
  and a warm hit equals the cold fold;
- a packed backend behind a service through a delta sequence with
  appends: answers, ``stats()["factor"]`` and the
  ``dpathsim_factor_bytes`` gauge equal to the JAX service's."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch import resilience
from distributed_pathsim_tpu_torch.backends.base import create_backend as tcreate
from distributed_pathsim_tpu_torch.resilience import inject
from torch_port_util import (
    assert_coo_equal,
    delta_graphs,
    make_delta,
    metapaths,
    overflow_hins,
    port_hin,
    random_delta_spec,
)


def _graphs(n=700, seed=9):
    jhin = jsyn.synthetic_hin(n, int(n * 10 / 7), 24, seed=seed)
    return jhin, port_hin(jhin)


def _pair(graphs, **knobs):
    """(jax-sparse, torch-sparse on the CPU) with the same knobs."""
    jmp, tmp = metapaths(graphs)
    return (jcreate("jax-sparse", graphs[0], jmp, **knobs),
            tcreate("torch-sparse", graphs[1], tmp, device="cpu", **knobs))


@pytest.fixture(autouse=True)
def clean_preemption(monkeypatch):
    monkeypatch.setenv("PATHSIM_RETRY_BASE_DELAY", "0")
    inject.reset()
    yield
    inject.reset()
    resilience.preemption_handler.reset()


@pytest.mark.parametrize(
    "fmt,knobs,path",
    [("blocked", {"tile_rows": 256, "rect_kernel": True}, "rect"),
     ("bitpacked", {"tile_rows": 256}, "scan-fold"),
     ("bitpacked", {"tile_rows": 300, "dense_c_budget_bytes": 0},
      "tile-fold")],
)
def test_packed_arms_equal_jax_sparse_and_coo(fmt, knobs, path):
    graphs = _graphs()
    jb, tb = _pair(graphs, factor_format=fmt, **knobs)
    coo = tcreate("torch-sparse", graphs[1], metapaths(graphs)[1],
                  device="cpu", **knobs)
    assert tb._run_config(10)["compute_path"] == path
    assert tb._run_config(10) == jb._run_config(10, False)
    assert tb.factor_info() == jb.factor_info()
    info = tb.factor_info()
    assert info["format"] == fmt and 0 < info["bytes"] < info["coo_bytes"]
    tv, ti = tb.topk_scores(k=10)
    for want in (jb.topk_scores(k=10), coo.topk_scores(k=10)):
        np.testing.assert_array_equal(tv, want[0])
        np.testing.assert_array_equal(ti, want[1])
    np.testing.assert_array_equal(tb.global_walks(), coo.global_walks())
    np.testing.assert_array_equal(tb.diag_walks(), coo.diag_walks())
    rows = [0, 5, 699]
    np.testing.assert_array_equal(tb.pairwise_rows(rows),
                                  coo.pairwise_rows(rows))


@pytest.mark.parametrize("fmt", ["coo", "bitpacked"])
def test_symmetric_sweep_equals_full_and_jax(fmt):
    """Tile rows smaller than N with a partial last tile, both score
    variants."""
    jb, tb = _pair(_graphs(), factor_format=fmt, tile_rows=256,
                   rect_kernel=True)
    assert (tb._run_config(10, symmetric=True)
            == jb._run_config(10, True))
    assert tb._run_config(10, symmetric=True)["compute_path"] == "sym"
    for variant in ("rowsum", "diagonal"):
        fv, fi = tb.topk_scores(k=10, variant=variant)
        sv, si = tb.topk_scores(k=10, variant=variant, symmetric=True)
        jv, ji = jb.topk_scores(k=10, variant=variant, symmetric=True)
        for v, i in ((sv, si), (jv, ji)):
            np.testing.assert_array_equal(v, fv)
            np.testing.assert_array_equal(i, fi)


def test_symmetric_exact_rescore_equals_full_and_jax():
    rng = np.random.default_rng(61)
    counts = np.zeros((48, 6), dtype=np.int64)
    mask = rng.random((48, 6)) < 0.6
    counts[mask] = rng.integers(1500, 4000, int(mask.sum()))
    jb, tb = _pair(overflow_hins(counts), tile_rows=16,
                   factor_format="blocked")
    assert tb._exact_rescore and jb._exact_rescore
    fv, fi = tb.topk_scores(k=5)
    sv, si = tb.topk_scores(k=5, symmetric=True)
    jv, ji = jb.topk_scores(k=5, symmetric=True)
    for v, i in ((sv, si), (jv, ji)):
        np.testing.assert_array_equal(v, fv)
        np.testing.assert_array_equal(i, fi)


def test_symmetric_resume_stale_snapshot_and_no_mixing(tmp_path,
                                                       monkeypatch):
    """A preemption requested at the 5th merge (outer tile 1 of 4) is
    honored at the next outer-tile boundary: rows of tiles 0 and 1 and a
    fresh ``sym_partials_after_1``; the resume redoes only tiles 2.. and
    returns the uninterrupted arrays. A stale snapshot left
    beside the newest is dropped on resume. Symmetric and full-sweep
    checkpoints refuse each other's directories."""
    graphs = _graphs()
    _, tb = _pair(graphs, tile_rows=192, factor_format="bitpacked")
    want = tb.topk_scores(k=7, symmetric=True)
    ck = str(tmp_path / "ck")
    monkeypatch.setenv(inject.ENV_VAR, "tile_execute:preempt:1@4")
    inject.reset()
    with pytest.raises(resilience.Preempted):
        tb.topk_scores(k=7, checkpoint_dir=ck, symmetric=True)
    from distributed_pathsim_tpu_torch.utils.checkpoint import (
        CheckpointManager,
    )

    assert CheckpointManager(ck).done_keys() == [
        "sym_partials_after_1", "topk7_rowtile_0", "topk7_rowtile_1"]
    monkeypatch.delenv(inject.ENV_VAR)
    inject.reset()
    resilience.preemption_handler.reset()
    _, fresh = _pair(graphs, tile_rows=192, factor_format="bitpacked")
    got = fresh.topk_scores(k=7, checkpoint_dir=ck, symmetric=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    mgr = CheckpointManager(ck)
    assert mgr.done_keys()[0] == "sym_partials_after_3"
    # a stale snapshot beside the newest (a crash between the save of the
    # new one and the drop of the old): dropped, the result unchanged
    mgr.save_unit("sym_partials_after_1",
                  **mgr.load_unit("sym_partials_after_3"))
    again = fresh.topk_scores(k=7, checkpoint_dir=ck, symmetric=True)
    for a, b in zip(again, want):
        np.testing.assert_array_equal(a, b)
    snaps = [k for k in CheckpointManager(ck).done_keys()
             if k.startswith("sym_partials_after_")]
    assert snaps == ["sym_partials_after_3"]
    # symmetric and full-sweep checkpoints never mix, either way round
    with pytest.raises(ValueError, match="on-disk format"):
        fresh.topk_scores(k=7, checkpoint_dir=ck)
    ck2 = str(tmp_path / "ck2")
    fresh.topk_scores(k=7, checkpoint_dir=ck2)
    with pytest.raises(ValueError, match="on-disk format"):
        fresh.topk_scores(k=7, checkpoint_dir=ck2, symmetric=True)


def test_packed_memo_charges_packed_bytes_and_hits_exactly():
    from distributed_pathsim_tpu.ops import planner as jplan
    from distributed_pathsim_tpu_torch.ops import planner as tplan

    jhin = jsyn.synthetic_hin(180, 360, 10, n_topics=6, seed=12)
    graphs = (jhin, port_hin(jhin))
    jmp, tmp = metapaths(graphs, "APTPA")
    coo = tplan.SubchainCache(32 << 20)
    pkd = tplan.SubchainCache(32 << 20, factor_format="bitpacked")
    jpkd = jplan.SubchainCache(32 << 20, factor_format="bitpacked")
    cold = tplan.fold_half(graphs[1], tmp, memo=pkd)
    assert_coo_equal(cold, tplan.fold_half(graphs[1], tmp, memo=coo))
    assert_coo_equal(cold, jplan.fold_half(jhin, jmp, memo=jpkd))
    assert 0 < pkd.stats()["bytes"] < coo.stats()["bytes"]
    assert pkd.stats() == jpkd.stats()
    warm = tplan.fold_half(graphs[1], tmp, memo=pkd)
    assert pkd.hits > 0
    assert_coo_equal(warm, cold)


@pytest.mark.parametrize("fmt", ["blocked", "bitpacked"])
def test_packed_service_delta_sequence_equals_jax(fmt):
    """Three updates (two with an appended author) through a packed
    torch-sparse service and a packed jax-sparse one: every answer, the
    factor block of ``stats()`` and the gauge equal, the factor patched
    in place (``mode == "delta"``)."""
    from distributed_pathsim_tpu.serving import PathSimService as JService
    from distributed_pathsim_tpu.serving import ServeConfig as JConfig
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry
    from distributed_pathsim_tpu_torch.serving import (
        PathSimService,
        ServeConfig,
    )

    jhin, thin = delta_graphs(headroom=0.3)
    jmp, tmp = metapaths((jhin, thin))
    js = JService(jcreate("jax-sparse", jhin, jmp, factor_format=fmt,
                          tile_rows=32),
                  config=JConfig(warm=False, compact_auto=False))
    ts = PathSimService(tcreate("torch-sparse", thin, tmp, device="cpu",
                                factor_format=fmt, tile_rows=32),
                        config=ServeConfig(warm=False, compact_auto=False))
    rng = np.random.default_rng(4)
    gauge = get_registry().gauge("dpathsim_factor_bytes").labels(format=fmt)
    try:
        assert ts.memo is None or ts.memo.factor_format == fmt
        for step in range(3):
            spec = random_delta_spec(ts.hin, rng, append=step != 1)
            from distributed_pathsim_tpu.data import delta as jdl
            from distributed_pathsim_tpu_torch.data import delta as tdl

            jr = js.update(make_delta(jdl, spec))
            tr = ts.update(make_delta(tdl, spec))
            assert tr["mode"] == jr["mode"] == "delta", tr
            tf, jf = ts.stats()["factor"], js.stats()["factor"]
            assert tf == jf and tf["format"] == fmt
            assert gauge.value == float(tf["bytes"])
            for row in (0, 5, ts.n - 1):
                tv, ti = ts.topk_index(row, 6)
                jv, ji = js.topk_index(row, 6)
                np.testing.assert_array_equal(tv, jv)
                np.testing.assert_array_equal(ti, ji)
        assert ts.backend.topk_scores(k=4)[1].tolist() == \
            js.backend.topk_scores(k=4)[1].tolist()
    finally:
        js.close()
        ts.close()
