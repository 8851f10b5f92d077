"""Port parity: background compaction (``serving/compact.py``) and its
token-preserving hot-swap against the JAX package's, on the CPU, same
numpy-seeded synthetic graphs, zero tolerance. The swap keeps the
consistency token, the chained fingerprint and both cache tiers; deltas
landing mid-build replay onto the new backend; the headroom trigger
compacts before the reserve runs out; ``compact_hin`` capacities, the
knobs and one mixed update/compaction sequence (answers, tokens,
fingerprints, accounting) equal the JAX package's; a failed build is
counted while the old backend keeps serving, and so is a build whose
every attempt (``compact_attempts``) was abandoned; the serve and router flags
of the lane parse and forward as the JAX CLIs do; and ``stats()`` answers
the JAX shape ``obs.tuning.{table, lookups, buckets}``."""

import time

import numpy as np
import pytest

from distributed_pathsim_tpu import tuning as jtuning
from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.router import cli as jrouter_cli
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.serving.compact import compact_hin as jcompact
from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import cli as router_cli
from distributed_pathsim_tpu_torch.serving import (
    PathSimService,
    ServeConfig,
    compact_hin,
)
from distributed_pathsim_tpu_torch.serving import cli as serve_cli
from torch_port_util import make_delta, port_hin, random_delta_spec


@pytest.fixture(autouse=True)
def no_tuning():
    """Both packages without a tuning table (restored afterwards)."""
    tuning.reset()
    jtuning.reset()
    prev = jtuning.dispatch._state.enabled
    jtuning.set_enabled(False)
    try:
        yield
    finally:
        jtuning.set_enabled(prev)
        tuning.reset()
        jtuning.reset()


def _graphs(headroom=0.25, n_authors=128, n_papers=224, n_venues=8, seed=0):
    raw = jsyn.synthetic_hin(n_authors, n_papers, n_venues, seed=seed,
                             materialize_ids=True)
    return (jdl.with_headroom(raw, headroom),
            tdl.with_headroom(port_hin(raw), headroom))


def _service(hin, **cfg):
    cfg.setdefault("max_wait_ms", 0.2)
    cfg.setdefault("warm", False)
    mp = compile_metapath("APVPA", hin.schema)
    return PathSimService(create_backend("torch", hin, mp, device="cpu"),
                          config=ServeConfig(**cfg))


def _jservice(hin, **cfg):
    cfg.setdefault("max_wait_ms", 0.2)
    cfg.setdefault("warm", False)
    mp = jmeta.compile_metapath("APVPA", hin.schema)
    return JService(jcreate("jax", hin, mp), config=JConfig(**cfg))


def _edge_delta(hin, rng, n):
    blk = hin.blocks["author_of"]
    existing = set(zip(blk.rows.tolist(), blk.cols.tolist()))
    adds = []
    while len(adds) < n:
        e = (int(rng.integers(0, hin.type_size("author"))),
             int(rng.integers(0, hin.type_size("paper"))))
        if e not in existing:
            existing.add(e)
            adds.append(e)
    return {"edges": [("author_of", np.asarray(adds, dtype=np.int64),
                       np.zeros((0, 2), dtype=np.int64))], "nodes": []}


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(a[0], b[0], err_msg=msg)
    np.testing.assert_array_equal(a[1], b[1], err_msg=msg)


def test_compact_preserves_token_fingerprint_and_caches():
    jhin, thin = _graphs()
    svc, jsvc = _service(thin), _jservice(jhin)
    try:
        spec = _edge_delta(thin, np.random.default_rng(0), 3)
        assert svc.update(make_delta(tdl, spec))["mode"] == "delta"
        jsvc.update(make_delta(jdl, spec))
        tok, fp = svc.consistency_token, svc._fp
        v1 = svc.topk_index(5, 5)
        svc.scores_index(9)
        hits0 = svc.stats()["result_cache"]["hits"]
        entries0 = len(svc.result_cache)
        tiles0 = svc.tile_cache.bytes_used
        res, jres = svc.compact(), jsvc.compact()
        assert res["swapped"], res
        assert res["capacity"] == jres["capacity"]
        assert res["token"] == jres["token"] == list(tok)
        # token, fingerprint, caches: all preserved — compaction is the
        # one "update" that invalidates nothing
        assert svc.consistency_token == tok and svc._fp == fp == jsvc._fp
        assert len(svc.result_cache) == entries0
        assert svc.tile_cache.bytes_used == tiles0
        _equal(svc.topk_index(5, 5), v1)
        assert svc.stats()["result_cache"]["hits"] == hits0 + 1
        cap = res["capacity"]["author"]
        assert cap >= svc.n and (cap & (cap - 1)) == 0
        assert svc.backend._c_shape[0] == cap  # the factor re-padded
        assert svc.health()["compaction"] == {"inflight": False, "count": 1}
        # a fresh row answers from the compacted backend as JAX's does
        _equal(svc.topk_index(77, 5), jsvc.topk_index(77, 5))
    finally:
        svc.close()
        jsvc.close()


def test_compact_replays_mid_build_deltas():
    """Deltas that land while the build is in flight replay onto the new
    backend at swap — the post-swap graph is the live graph, and answers
    stay bit-identical to an oracle that absorbed everything
    sequentially (the port's and the JAX package's)."""
    jhin, thin = _graphs()
    svc = _service(thin)
    oracle, joracle = _service(thin), _jservice(jhin)
    try:
        rng = np.random.default_rng(1)
        real_factory = svc._backend_factory

        def slow_factory(h):
            time.sleep(0.15)
            return real_factory(h)

        svc._backend_factory = slow_factory
        svc._compactor.chain_len = 3
        svc._compactor.cooldown_s = 0.0
        specs = []
        for i in range(6):
            specs.append(_edge_delta(svc.hin, rng, 2))
            svc.update(make_delta(tdl, specs[-1]))
            if i == 2:
                # the chain trigger just fired: wait until the build has
                # its snapshot, so the remaining updates land inside it
                deadline = time.monotonic() + 5
                while (not svc._compactor.inflight
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                time.sleep(0.03)
        svc._compactor._done.wait(30.0)
        comp = svc.stats()["compaction"]
        assert comp["compactions"] >= 1 and comp["failures"] == 0, comp
        assert (comp["last"].get("replayed_deltas", 0) > 0
                or comp["compactions"] > 1), comp
        for spec in specs:
            oracle.update(make_delta(tdl, spec))
            joracle.update(make_delta(jdl, spec))
        assert svc.consistency_token == oracle.consistency_token == \
            joracle.consistency_token
        assert svc._fp == oracle._fp == joracle._fp
        for row in (0, 7, 42, 99):
            got = svc.topk_index(row, 5)
            _equal(got, oracle.topk_index(row, 5))
            _equal(got, joracle.topk_index(row, 5))
    finally:
        svc.close()
        oracle.close()
        joracle.close()


def test_headroom_trigger_compacts_before_exhaustion():
    """A sustained append stream with auto compaction on never hits the
    synchronous headroom-exhausted inline rebuild: the background
    re-encode refreshes the reserve first."""
    _, thin = _graphs(headroom=0.10)
    svc = _service(
        thin, compact_auto=True, compact_chain_len=10_000,
        compact_headroom_frac=0.5, compact_cooldown_s=0.0,
        compact_headroom=1.0,
    )
    try:
        rng = np.random.default_rng(2)
        for i in range(40):
            n_auth = svc.hin.type_size("author")
            svc.update(tdl.DeltaBatch(
                edges=(tdl.edge_delta(
                    "author_of", add=[(n_auth, int(rng.integers(0, 224)))]),),
                nodes=(tdl.NodeAppend(node_type="author",
                                      ids=(f"fh_a{i}",)),),
            ))
            svc._compactor._done.wait(30.0)
        st = svc.stats()
        assert st["delta"]["rebuilds"] == 0, st["delta"]
        assert st["compaction"]["compactions"] >= 1
        assert st["compaction"]["failures"] == 0
        assert st["delta"]["seq"] == 40
        # the appended rows answer exactly as a fresh build of the graph
        fresh = create_backend("numpy", svc.hin, svc.metapath)
        for row in (0, svc.n - 1):
            _equal(svc.topk_index(row, 5), fresh.topk_row(row, 5))
    finally:
        svc.close()


def test_compact_hin_capacities_equal_jax():
    for headroom in (0.0, 0.1, 0.25, 1.0):
        jhin, thin = _graphs(headroom=0.25, n_authors=300, n_papers=450,
                             n_venues=13)
        a, b = jcompact(jhin, headroom), compact_hin(thin, headroom)
        for t in thin.indices:
            assert b.indices[t].capacity == a.indices[t].capacity, t
            assert b.indices[t].size == a.indices[t].size, t
        for rel in thin.blocks:
            assert tuple(b.blocks[rel].shape) == tuple(a.blocks[rel].shape)
            np.testing.assert_array_equal(b.blocks[rel].rows,
                                          thin.blocks[rel].rows)
    # types that never reserved capacity keep capacity None
    raw = jsyn.synthetic_hin(40, 60, 5, seed=1)
    assert all(ix.capacity is None
               for ix in compact_hin(port_hin(raw), 0.5).indices.values())


def test_mixed_update_compaction_sequence_equals_jax_service():
    """Random patches (one with an appended author) and forced
    compactions, interleaved: after every step the update results,
    compaction accounting, tokens, fingerprints and every row's answer
    equal the JAX service's."""
    jhin, thin = _graphs(n_authors=96, n_papers=160, n_venues=7, seed=4)
    svc = _service(thin, compact_auto=False)
    jsvc = _jservice(jhin, compact_auto=False)
    rng = np.random.default_rng(4)
    timing = ("ms", "build_ms", "pause_ms", "total_ms", "compiles")
    try:
        for step in ("delta", "compact", "append", "delta", "compact",
                     "compact", "delta"):
            if step == "compact":
                a, b = jsvc.compact(), svc.compact()
            else:
                spec = random_delta_spec(svc.hin, rng, n_changes=10,
                                         append=step == "append")
                a = jsvc.update(make_delta(jdl, spec))
                b = svc.update(make_delta(tdl, spec))
            assert {k: v for k, v in b.items() if k not in timing} == {
                k: v for k, v in a.items() if k not in timing}, step
            assert svc.consistency_token == jsvc.consistency_token
            assert svc._fp == jsvc._fp
            for row in range(svc.n):
                _equal(svc.topk_index(row, 5), jsvc.topk_index(row, 5),
                       f"{step} row {row}")
        sc, jc = svc.stats()["compaction"], jsvc.stats()["compaction"]
        assert {k: v for k, v in sc.items() if k != "last"} == {
            k: v for k, v in jc.items() if k != "last"}
        assert sc["compactions"] == 3 and sc["failures"] == 0
    finally:
        svc.close()
        jsvc.close()


def test_stats_obs_tuning_matches_jax_shape():
    """``stats()["obs"]["tuning"]`` is the JAX package's block: the
    active table's digest (None untuned), the lookup counts and the
    bucket ladder — which follows a tuned ``serve_buckets`` choice."""
    jhin, thin = _graphs()
    svc, jsvc = _service(thin, max_batch=8), _jservice(jhin, max_batch=8)
    try:
        obs, jobs = svc.stats()["obs"], jsvc.stats()["obs"]
        assert set(obs) == set(jobs)
        assert set(obs["tuning"]) == set(jobs["tuning"]) == {
            "table", "lookups", "buckets"}
        assert obs["tuning"]["table"] is None is jobs["tuning"]["table"]
        assert obs["tuning"]["buckets"] == jobs["tuning"]["buckets"] == [
            1, 2, 4, 8]
        assert "buckets" not in obs
    finally:
        svc.close()
        jsvc.close()
    tuning.set_enabled(True)
    table = tuning.TuningTable(tuning.device_kind())
    table.put(tuning.make_key("serve_buckets", tuning.device_kind(),
                              n=thin.type_size("author"), v=8), "coarse")
    tuning.set_table(table)
    svc = _service(thin, max_batch=8)
    try:
        st = svc.stats()["obs"]["tuning"]
        assert st["buckets"] == [1, 4, 16]
        assert st["table"] == table.digest
        assert st["lookups"].get("hit", 0) >= 1
    finally:
        svc.close()


def test_compaction_knobs_equal_jax():
    _, thin = _graphs()
    svc = _service(thin)
    jsvc = _jservice(_graphs()[0])
    try:
        for knob, default in (("compact_chain_len", 256),
                              ("compact_headroom", 0.25)):
            assert knob in tuning.KNOBS
            assert (tuning.KNOBS[knob].candidates({})
                    == jtuning.KNOBS[knob].candidates({}))
            assert tuning.make_key(knob, "cpu", n=svc.n) == \
                jtuning.make_key(knob, "cpu", n=svc.n)
            assert tuning.choose(knob, n=svc.n, default=default) == default
        assert svc.stats()["compaction"] == jsvc.stats()["compaction"]
        assert svc.stats()["compaction"]["chain_len"] == 256
        assert svc.stats()["compaction"]["fresh_headroom"] == 0.25
    finally:
        svc.close()
        jsvc.close()


def test_failed_build_is_counted_and_the_old_backend_serves():
    _, thin = _graphs()
    svc = _service(thin, compact_auto=True, compact_chain_len=1,
                   compact_cooldown_s=0.0)
    try:
        before = svc.topk_index(3, 5)
        backend = svc.backend

        def broken(h):
            raise RuntimeError("injected build failure")

        svc._backend_factory = broken
        res = svc.compact()
        assert not res["swapped"] and "injected" in res["error"]
        # a chain-triggered background build fails the same way
        svc.update(make_delta(tdl, _edge_delta(svc.hin,
                                               np.random.default_rng(5), 1)))
        svc._compactor._done.wait(30.0)
        comp = svc.stats()["compaction"]
        assert comp["failures"] == 2 and comp["compactions"] == 0, comp
        assert not comp["inflight"]
        assert svc.backend is backend
        fresh = create_backend("numpy", svc.hin, svc.metapath)
        _equal(svc.topk_index(3, 5), fresh.topk_row(3, 5))
        assert before is not None
    finally:
        svc.close()


def test_abandoned_attempts_are_bounded_as_in_jax():
    """``compact_attempts`` bounds a build whose token keeps moving:
    every abandoned attempt is counted, and the last one fails the
    compaction with the old backend still serving, as in the JAX
    compactor (the swap doorway is made to abandon on both sides)."""
    attempts = 2  # not the default 3: the bound is read from the config
    jhin, thin = _graphs()
    svc = _service(thin, compact_attempts=attempts)
    jsvc = _jservice(jhin, compact_attempts=attempts)
    try:
        backend = svc.backend
        for s in (svc, jsvc):
            s._apply_compaction = lambda *a: {"abandoned": "token moved"}
        res, jres = svc.compact(), jsvc.compact()
        assert res == jres
        assert res["attempts"] == attempts and not res["swapped"]
        comp, jcomp = svc.stats()["compaction"], jsvc.stats()["compaction"]
        assert (comp["abandoned"], comp["failures"]) == (attempts, 1)
        assert {k: comp[k] for k in ("abandoned", "failures",
                                     "compactions")} == {
            k: jcomp[k] for k in ("abandoned", "failures", "compactions")}
        assert svc.backend is backend
        _equal(svc.topk_index(3, 5), jsvc.topk_index(3, 5))
    finally:
        svc.close()
        jsvc.close()


def test_serve_and_router_flags_of_the_lanes():
    argv = ["--dataset", "g.gexf", "--memo-budget-mb", "16",
            "--max-metapaths", "3", "--no-compact", "--compact-chain-len",
            "64", "--compact-headroom-frac", "0.2", "--compact-headroom",
            "0.5", "--compact-cooldown", "1.5"]
    cfg = serve_cli.serve_config(serve_cli.parse_serve_args(argv))
    assert (cfg.memo_budget_mb, cfg.max_metapaths, cfg.compact_auto,
            cfg.compact_chain_len, cfg.compact_headroom_frac,
            cfg.compact_headroom, cfg.compact_cooldown_s) == (
        16.0, 3, False, 64, 0.2, 0.5, 1.5)
    for flag in ("--memo-budget-mb", "--max-metapaths", "--no-compact",
                 "--compact-chain-len", "--compact-headroom-frac",
                 "--compact-headroom", "--compact-cooldown"):
        assert flag not in serve_cli.NOT_PORTED_FLAGS
    # the router forwards to its workers what the JAX router forwards of
    # these lanes, and nothing more
    lane = {"memo_budget_mb", "max_metapaths", "no_compact",
            "compact_chain_len", "compact_headroom_frac",
            "compact_headroom", "compact_cooldown"}
    ours = set(router_cli._FORWARD_VALUE + router_cli._FORWARD_TRUE) & lane
    jax = set(jrouter_cli._FORWARD_VALUE + jrouter_cli._FORWARD_TRUE) & lane
    assert ours == jax
    args = router_cli.build_router_parser().parse_args(
        ["--dataset", "g.gexf", "--no-compact", "--compact-chain-len", "64"])
    worker = router_cli._worker_argv(args, 0)
    assert "--no-compact" in worker
    assert worker[worker.index("--compact-chain-len") + 1] == "64"
