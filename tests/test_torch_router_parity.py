"""Routed answers: the port's Router over three InprocTransport workers
against the JAX package's Router over three, on the same synthetic
graph, on the CPU. ``topk`` and ``scores`` answers are bit-identical
(ids, labels, f64 scores, tie order); after one broadcast ``update``
both fleets hold the same consistency token and answer every row (the
appended one included) the same; the routed answers equal one port service's. The JAX
services run with the tuning table off and compaction off, the
configuration the port mirrors."""

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
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from torch_port_util import delta_graphs

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


def _port_fleet(thin, n=3):
    mp = compile_metapath("APVPA", thin.schema)
    ts = {f"w{i}": InprocTransport(f"w{i}", WorkerRuntime(
        PathSimService(create_backend("torch", thin, mp, device="cpu"),
                       config=ServeConfig(**CFG)), f"w{i}"))
        for i in range(n)}
    r = Router(ts, RouterConfig(**ROUTER))
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
