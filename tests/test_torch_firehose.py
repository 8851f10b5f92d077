"""A replica killed mid-compaction in the port's fleet, on the CPU — the
``chaos`` twin of tests/test_firehose.py's kill: one of two ``torch``
replicas SIGKILLed while both compact under query load loses no request;
the survivor swaps cleanly (token unchanged, answers exact) and a
freshly added replica catches up by epoch replay to answers
bit-identical to an f64 oracle that absorbed the same deltas."""

import time

import numpy as np
import pytest

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as dl
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig


def _mk_hin():
    return dl.with_headroom(
        synthetic_hin(96, 160, 6, seed=4, materialize_ids=True), 0.25)


def _service(hin, mp, backend="torch"):
    opts = {"device": "cpu"} if backend == "torch" else {}
    return PathSimService(create_backend(backend, hin, mp, **opts),
                          config=ServeConfig(max_wait_ms=0.2, warm=False))


def _fresh_edges(hin, rng, n):
    ap = hin.blocks["author_of"]
    existing = set(zip(ap.rows.tolist(), ap.cols.tolist()))
    adds = []
    while len(adds) < n:
        e = (int(rng.integers(0, 96)), int(rng.integers(0, 160)))
        if e not in existing:
            existing.add(e)
            adds.append(e)
    return [{"rel": "author_of", "src_row": r, "dst_row": c}
            for r, c in adds]


@pytest.mark.chaos
def test_kill_worker_mid_compaction():
    mp = compile_metapath("APVPA", _mk_hin().schema)

    def make_transport(wid: str):
        svc = _service(_mk_hin(), mp)
        # widen the compaction window so the kill lands inside it
        real_factory = svc._backend_factory

        def slow_factory(h):
            time.sleep(0.25)
            return real_factory(h)

        svc._backend_factory = slow_factory
        return InprocTransport(wid, WorkerRuntime(svc, worker_id=wid))

    transports = {w: make_transport(w) for w in ("w0", "w1")}
    router = Router(transports, RouterConfig(
        heartbeat_interval_s=0.05, heartbeat_miss_limit=100,
        hedge_ms=None, max_inflight=8192, scrape_interval_s=0,
        retain_replay=True,
    ))
    router.start()
    oracle = _service(_mk_hin(), mp, backend="numpy")
    try:
        rng = np.random.default_rng(4)
        for _ in range(4):
            recs = _fresh_edges(oracle.hin, rng, 2)
            resp = router.request({"op": "update", "add_edges": recs},
                                  timeout=30)
            assert resp["ok"], resp
            oracle.update(dl.delta_from_records(oracle.hin, add_edges=recs))
        tok_before = oracle.consistency_token
        # both replicas start compacting (the op blocks each worker's
        # loop mid-build); queries and the kill land inside the window
        for wid in ("w0", "w1"):
            router.workers[wid].transport.send(
                {"op": "compact", "id": f"force-{wid}"})
        futs = [router.submit({"op": "topk", "row": int(r), "k": 5})
                for r in rng.integers(0, 96, size=24)]
        time.sleep(0.05)  # inside w0's slowed build
        router.workers["w0"].transport.kill()
        lost = sum(1 for f in futs if not f.result(timeout=60).get("ok"))
        assert lost == 0
        # the survivor swapped cleanly: compaction ran, token unchanged
        svc1 = transports["w1"].runtime.service
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if svc1._compactor.compactions >= 1 and (
                    not svc1._compactor.inflight):
                break
            time.sleep(0.02)
        assert svc1._compactor.compactions >= 1
        assert svc1.consistency_token == tok_before
        # keep the stream going on the survivor
        recs = _fresh_edges(oracle.hin, rng, 2)
        resp = router.request({"op": "update", "add_edges": recs},
                              timeout=30)
        assert resp["ok"], resp
        oracle.update(dl.delta_from_records(oracle.hin, add_edges=recs))
        # a spawned replacement catches up by epoch replay ...
        transports["w2"] = make_transport("w2")
        router.add_worker("w2", transports["w2"])
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with router._lock:
                head = len(router._epochs) - 1
                if router.workers["w2"].epoch == head:
                    break
            time.sleep(0.02)
        with router._lock:
            assert router.workers["w2"].epoch == len(router._epochs) - 1
        # ... to answers bit-identical to the oracle
        for row in (0, 9, 33, 80):
            resp = router.request({"op": "topk", "row": row, "k": 5},
                                  timeout=30)
            assert resp["ok"], resp
            vals, idxs = oracle.topk_index(row, 5)
            want = [(oracle._ident(int(j))[0], float(v))
                    for v, j in zip(vals, idxs) if np.isfinite(v)]
            assert [(h["id"], h["score"])
                    for h in resp["result"]["topk"]] == want
    finally:
        router.close()
        oracle.close()
        for t in transports.values():
            t.runtime.service.close()
