"""The router's firehose and autoscale planes in the port, on the CPU,
over in-process workers.

- Queued updates (``update_queue``) fold into fewer broadcasts: every
  member resolves ok, a coalesced group says so, and the fleet then
  answers every row as one f64 service that applied the same updates
  one by one; past the queue bound an update is refused at once with
  ``backpressure``.
- The autoscaler spawns a replica on a high signal — the new worker
  boots the base graph and catches up by replaying the epoch log before
  it answers — and drains the highest-numbered one on a low signal; its
  decision log records both.
"""

import time

import numpy as np

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import (
    AutoscaleConfig,
    Autoscaler,
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.router.cli import build_worker_hin
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request

SPEC = "synthetic:authors=96,papers=150,venues=6,seed=4"
QUIET = {"hedge_ms": None, "scrape_interval_s": 0.0,
         "heartbeat_interval_s": 0.5, "heartbeat_miss_limit": 40}


def _service(hin, backend="torch"):
    mp = compile_metapath("APVPA", hin.schema)
    opts = {"device": "cpu"} if backend == "torch" else {}
    return PathSimService(create_backend(backend, hin, mp, **opts),
                          config=ServeConfig(max_batch=8, warm=False))


def _transport(hin, wid):
    return InprocTransport(wid, WorkerRuntime(_service(hin), wid))


def _updates(hin, n):
    """``n`` non-conflicting single-edge adds on distinct authors."""
    blk = hin.blocks["author_of"]
    have = set(zip(blk.rows.tolist(), blk.cols.tolist()))
    out = []
    for a in range(n):
        p = next(p for p in range(hin.type_size("paper"))
                 if (a, p) not in have)
        out.append({"id": a, "op": "update", "add_edges": [
            {"rel": "author_of", "src_row": a, "dst_row": p}]})
    return out


def _assert_answers(router, oracle, rows, k=5):
    futs = [router.submit({"op": "topk", "row": int(r), "k": k})
            for r in rows]
    for r, f in zip(rows, futs):
        resp = f.result(timeout=60)
        assert resp["ok"], resp
        want = [{"id": i, "label": lab, "score": s}
                for i, lab, s in oracle.topk(row=int(r), k=k)]
        assert resp["result"]["topk"] == want, r


def _close(router, transports):
    router.close()
    for t in transports:
        t.runtime.service.close()


def test_update_queue_coalesces_and_pushes_back():
    hin = build_worker_hin(SPEC, 0.25)
    transports = [_transport(hin, f"w{i}") for i in range(2)]
    router = Router({t.worker_id: t for t in transports}, RouterConfig(
        update_queue=32, update_coalesce=8, update_flush_ms=200.0, **QUIET))
    oracle = _service(hin, "numpy")
    try:
        router.start()
        updates = _updates(hin, 6)
        futs = [router.submit(dict(u)) for u in updates]
        resps = [f.result(timeout=60) for f in futs]
        assert all(r["ok"] for r in resps), resps
        assert [r["id"] for r in resps] == list(range(6))
        assert max(r.get("coalesced", 1) for r in resps) >= 2
        assert router.updates_coalesced >= 2
        for u in updates:
            assert handle_request(oracle, dict(u))["ok"]
        _assert_answers(router, oracle, np.arange(oracle.n))
        seqs = {t.runtime.service.consistency_token[1] for t in transports}
        assert seqs == {router.update_broadcasts}
    finally:
        _close(router, transports)
        oracle.close()
    # a queue bound of 2 with a lingering pump: the third and fourth
    # updates are refused at admission
    transports = [_transport(hin, "w0")]
    router = Router({"w0": transports[0]}, RouterConfig(
        update_queue=2, update_flush_ms=300.0, **QUIET))
    try:
        router.start()
        resps = [router.submit(dict(u)) for u in _updates(hin, 4)]
        resps = [f.result(timeout=60) for f in resps]
        assert [r["ok"] for r in resps] == [True, True, False, False]
        assert all(r.get("backpressure") for r in resps[2:])
        assert router.update_backpressure == 2
    finally:
        _close(router, transports)


def test_autoscale_spawns_with_catch_up_and_drains():
    hin = build_worker_hin(SPEC, 0.25)
    spawned = []

    def factory(wid):
        spawned.append(_transport(hin, wid))  # boots the BASE graph
        return spawned[-1]

    seed = [_transport(hin, "w0")]
    router = Router({"w0": seed[0]}, RouterConfig(retain_replay=True,
                                                  **QUIET))
    cfg = AutoscaleConfig(min_workers=1, max_workers=2, up_consecutive=1,
                          down_consecutive=1, cooldown_ticks=0,
                          pending_high=0.0)  # every tick reads high
    scaler = Autoscaler(router, factory, cfg)
    oracle = _service(hin, "numpy")
    try:
        router.start()
        for u in _updates(hin, 2):  # two epochs the spawn must replay
            assert router.request(dict(u), timeout=60)["ok"]
            assert handle_request(oracle, dict(u))["ok"]
        rec = scaler.tick()
        assert rec["action"] == "spawn" and rec["spawned"] == "w1"
        for _ in range(400):  # the first pong starts the ordered replay
            if router.stats()["router"]["workers"]["w1"]["lag"] == 0:
                break
            time.sleep(0.01)
        assert spawned[0].runtime.service.consistency_token == (
            seed[0].runtime.service.consistency_token)
        _assert_answers(router, oracle, np.arange(oracle.n))
        cfg.pending_high = 1e9  # now every tick reads low
        rec = scaler.tick()
        assert rec["action"] == "drain" and rec["drained"] == "w1"
        for _ in range(400):
            if router.workers["w1"].status == "down":
                break
            time.sleep(0.01)
        scaler.tick()  # reaps the drained replica
        assert sorted(router.workers) == ["w0"]
        assert [d["action"] for d in scaler.decisions] == [
            "spawn", "drain", "hold"]
        _assert_answers(router, oracle, np.arange(0, oracle.n, 7))
    finally:
        _close(router, seed + spawned)
        oracle.close()
