"""Routed answers: the port's Router over three InprocTransport workers
against the JAX package's Router over three, on the same synthetic
graph, on the CPU. ``topk`` and ``scores`` answers are bit-identical
(ids, labels, f64 scores, tie order); after one broadcast ``update``
both fleets hold the same consistency token and answer every row (the
appended one included) the same; the routed answers equal one port service's. The JAX
services run with the tuning table off and compaction off, the
configuration the port mirrors. A routed per-request ``metapath`` is
held against one port service, also while a replica that missed an
update is fenced."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.router import InprocTransport as JInproc
from distributed_pathsim_tpu.router import Router as JRouter
from distributed_pathsim_tpu.router import RouterConfig as JRouterConfig
from distributed_pathsim_tpu.router import WorkerRuntime as JRuntime
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.delta import with_headroom
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.resilience import inject
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request
from torch_port_util import delta_graphs, port_hin

CFG = {"max_batch": 8, "max_wait_ms": 1.0, "warm": False}
# quiet maintenance: no hedges (each answer from its primary) and no
# scrapes; heartbeats slow enough that no replica is ever suspected
ROUTER = {"hedge_ms": None, "scrape_interval_s": 0.0,
          "heartbeat_interval_s": 0.5, "heartbeat_miss_limit": 40}


@pytest.fixture
def no_tuning():
    prev = jtuning._state.enabled
    jtuning.set_enabled(False)
    try:
        yield
    finally:
        jtuning.set_enabled(prev)


def _jax_fleet(jhin, n=3):
    mp = jmeta.compile_metapath("APVPA", jhin.schema)
    ts = {f"w{i}": JInproc(f"w{i}", JRuntime(
        JService(jcreate("jax", jhin, mp),
                 config=JConfig(compact_auto=False, **CFG)), f"w{i}"))
        for i in range(n)}
    r = JRouter(ts, JRouterConfig(**ROUTER))
    r.start()
    return r, ts


def _port_fleet(thin, n=3, **router):
    mp = compile_metapath("APVPA", thin.schema)
    ts = {f"w{i}": InprocTransport(f"w{i}", WorkerRuntime(
        PathSimService(create_backend("torch", thin, mp, device="cpu"),
                       config=ServeConfig(compact_auto=False, **CFG)),
        f"w{i}"))
        for i in range(n)}
    r = Router(ts, RouterConfig(**{**ROUTER, **router}))
    r.start()
    return r, ts


def _close(router, transports):
    router.close()
    for t in transports.values():
        t.runtime.service.close()


def _answers(router, reqs):
    futs = [router.submit(dict(r)) for r in reqs]
    out = []
    for f in futs:
        resp = f.result(timeout=60)
        assert resp["ok"], resp
        out.append(resp["result"])
    return out


def _queries(n, rows, k=5):
    return ([{"id": i, "op": "topk", "row": int(r), "k": k}
             for i, r in enumerate(rows)]
            + [{"id": 1000 + i, "op": "scores", "row": int(r)}
               for i, r in enumerate(rows[:8])])


def test_routed_answers_match_jax_router(no_tuning):
    jhin, thin = delta_graphs()
    jr, jts = _jax_fleet(jhin)
    tr, tts = _port_fleet(thin)
    try:
        assert tr.n == jr.n
        assert [e.token for e in tr._epochs] == [e.token for e in jr._epochs]
        reqs = _queries(tr.n, np.arange(tr.n))
        reqs.append({"id": 2000, "op": "topk", "k": 3,
                     "source_id": thin.indices["author"].ids[11]})
        assert _answers(tr, reqs) == _answers(jr, reqs)
        # every replica answered some rows: the policies spread alike
        assert all(t.runtime.service.coalescer.dispatched_requests
                   for t in tts.values())
    finally:
        _close(tr, tts)
        _close(jr, jts)


def test_broadcast_update_matches_jax_router(no_tuning):
    jhin, thin = delta_graphs()
    jr, jts = _jax_fleet(jhin)
    tr, tts = _port_fleet(thin)
    try:
        rows = np.arange(tr.n)
        _answers(tr, _queries(tr.n, rows))  # fill every replica's caches
        _answers(jr, _queries(jr.n, rows))
        ids = thin.indices["author"].ids
        papers = thin.indices["paper"].ids
        blk = thin.blocks["author_of"]
        upd = {"id": 7, "op": "update",
               "add_nodes": [{"type": "author", "id": "a_new",
                              "label": "A. New"}],
               "add_edges": [{"rel": "author_of", "src": "a_new",
                              "dst": papers[4]},
                             {"rel": "author_of", "src": ids[2],
                              "dst": papers[9]}],
               "remove_edges": [{"rel": "author_of",
                                 "src_row": int(blk.rows[0]),
                                 "dst_row": int(blk.cols[0])}]}
        tres = tr.request(dict(upd), timeout=60)
        jres = jr.request(dict(upd), timeout=60)
        assert tres["ok"] and jres["ok"], (tres, jres)
        assert tres == jres
        assert tres["result"]["applied"] == ["w0", "w1", "w2"]
        assert tres["result"]["mode"] == "delta"
        for t in tts.values():
            assert t.runtime.service.consistency_token == (
                jts["w0"].runtime.service.consistency_token)
        assert [e.token for e in tr._epochs] == [e.token for e in jr._epochs]
        assert tres["result"]["affected_rows"] > 0
        probe = np.arange(tr.n + 1)  # the appended author too
        assert _answers(tr, _queries(tr.n, probe)) == _answers(
            jr, _queries(jr.n, probe))
    finally:
        _close(tr, tts)
        _close(jr, jts)


def test_routed_answers_equal_one_port_service():
    _, thin = delta_graphs(seed=9)
    mp = compile_metapath("APVPA", thin.schema)
    svc = PathSimService(create_backend("torch", thin, mp, device="cpu"),
                         config=ServeConfig(**CFG))
    tr, tts = _port_fleet(thin, n=2)
    try:
        rows = np.arange(svc.n)
        got = _answers(tr, [{"id": int(r), "op": "topk", "row": int(r),
                             "k": 10} for r in rows])
        for r, res in zip(rows, got):
            want = [{"id": i, "label": lab, "score": s}
                    for i, lab, s in svc.topk(row=int(r), k=10)]
            assert res == {"row": int(r), "topk": want}
        for r in (0, 5, 40):
            res = tr.request({"op": "scores", "row": r}, timeout=60)
            assert res["result"]["scores"] == svc.scores_index(r).tolist()
    finally:
        svc.close()
        _close(tr, tts)


def test_routed_per_request_metapath_equals_one_port_service():
    """A ``metapath`` field rides the routed ``topk`` and ``scores`` to
    the worker, whose engine for it answers as one service's does (the
    JAX package's worker answers ``topk`` for the served metapath
    whatever the field says, so this is held against the port only)."""
    _, thin = delta_graphs(seed=5)
    mp = compile_metapath("APVPA", thin.schema)
    svc = PathSimService(create_backend("torch", thin, mp, device="cpu"),
                         config=ServeConfig(compact_auto=False, **CFG))
    tr, tts = _port_fleet(thin, n=2)
    try:
        rows = np.arange(svc.n)
        got = _answers(tr, [{"id": int(r), "op": "topk", "row": int(r),
                             "k": 6, "metapath": "APA"} for r in rows])
        for r, res in zip(rows, got):
            want = [{"id": i, "label": lab, "score": s} for i, lab, s in
                    svc.topk(row=int(r), k=6, metapath="APA")]
            assert res == {"row": int(r), "topk": want}
        assert got != _answers(tr, [{"id": int(r), "op": "topk",
                                     "row": int(r), "k": 6} for r in rows])
        for r in (0, 5, 40):
            res = tr.request({"op": "scores", "row": r, "metapath": "APA"},
                             timeout=60)
            assert res["result"]["scores"] == svc.scores_index(
                r, metapath="APA").tolist()
        bad = tr.request({"op": "topk", "row": 1, "metapath": "APV"},
                         timeout=60)
        assert not bad["ok"] and "not closed" in bad["error"]
        for t in tts.values():
            assert "APA" in t.runtime.service.stats()["plan"]["engines"]
    finally:
        svc.close()
        _close(tr, tts)


def _edge_update(thin, rel, rng, n):
    """An update request of ``n`` added and ``n`` removed ``rel`` edges,
    by row."""
    b = thin.blocks[rel]
    have = set(zip(b.rows.tolist(), b.cols.tolist()))
    adds = []
    while len(adds) < n:
        e = (int(rng.integers(0, thin.type_size(b.src_type))),
             int(rng.integers(0, thin.type_size(b.dst_type))))
        if e not in have:
            have.add(e)
            adds.append(e)
    rem = rng.choice(b.nnz, size=n, replace=False)
    return {"id": 9, "op": "update",
            "add_edges": [{"rel": rel, "src_row": s, "dst_row": d}
                          for s, d in adds],
            "remove_edges": [{"rel": rel, "src_row": int(b.rows[i]),
                              "dst_row": int(b.cols[i])} for i in rem]}


@pytest.mark.parametrize("rel,n", [("has_topic", 6), ("author_of", 1)])
def test_routed_metapath_fenced_on_a_lagging_replica(rel, n):
    """A replica that missed a broadcast update is fenced only from the
    rows the served metapath (APVPA) changed; an APTPA answer can change
    outside that set (a topic-only update changes no APVPA row at all).
    The replica made to miss the update is the first choice of a row
    whose APTPA answer changed outside that set, and every routed APTPA
    answer must still equal a caught-up service's: a request naming a
    metapath goes only to caught-up replicas while any fence is active.
    Heartbeats are slow enough that the lagging replica is not caught up
    during the test. The graph has many venues, so one author_of edge
    leaves APVPA rows unaffected whose APTPA answers change."""
    thin = with_headroom(port_hin(jsyn.synthetic_hin(
        128, 100, 64, n_topics=6, topics_per_paper=1.4, seed=4,
        materialize_ids=True)), 0.3)
    mp = compile_metapath("APVPA", thin.schema)
    ref = PathSimService(create_backend("torch", thin, mp, device="cpu"),
                         config=ServeConfig(compact_auto=False, **CFG))
    upd = _edge_update(thin, rel, np.random.default_rng(7), n=n)
    rows = range(ref.n)
    before = {r: ref.topk(row=r, k=5, metapath="APTPA") for r in rows}
    out = handle_request(ref, {**upd, "want_rows": True})
    assert out["ok"], out
    affected = set(out["result"]["affected_row_list"])
    if rel == "has_topic":
        assert not affected
    want = {r: ref.topk(row=r, k=5, metapath="APTPA") for r in rows}
    stale = [r for r in rows if r not in affected and want[r] != before[r]]
    assert stale
    tr, tts = _port_fleet(thin, n=3, heartbeat_interval_s=60.0)
    lag = tr.policy.preference(stale[0])[0]
    inject.install_plan(
        f"delta_broadcast:error:1@{list(tr.workers).index(lag)}")
    try:
        res = tr.request(dict(upd), timeout=60)
        assert res["ok"], res
        assert res["result"]["lagging"] == [lag]
        got = _answers(tr, [{"id": r, "op": "topk", "row": r, "k": 5,
                             "metapath": "APTPA"} for r in rows])
        for r, g in zip(rows, got):
            assert g == {"row": r, "topk": [
                {"id": i, "label": lab, "score": s}
                for i, lab, s in want[r]]}, r
        assert tr.workers[lag].epoch < len(tr._epochs) - 1  # still fenced
    finally:
        inject.reset()
        ref.close()
        _close(tr, tts)
