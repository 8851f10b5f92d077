"""Port twins of the JAX package's router smokes, on the CPU.

- ``test_router_smoke``: the port harness's router regime
  (``distributed_pathsim_tpu_torch.bench_serving.run_router_smoke``,
  the twin of tests/test_router.py::test_bench_router_smoke): real
  ``dpathsim-torch worker`` subprocesses (``--platform cpu``), one and
  two replicas, closed-loop load, one SIGKILL mid-load — zero lost
  requests, every answer equal to a single f64 (numpy) service's, a
  failover counted, zero compiles added on the survivor.
- ``test_chaos_router_smoke``: three in-process workers under a fault
  plan (transient dispatch errors, a stall, dropped heartbeats, a missed
  delta broadcast) and a kill — zero lost, every answer oracle-exact
  before and after the update (::test_chaos_router_smoke). The plan is
  installed here and removed in ``finally``, so none leaks into another
  test file on the same worker process.
"""

import pytest

from distributed_pathsim_tpu_torch import bench_serving as bs
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.resilience import inject
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.router.cli import build_worker_hin
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request

SPEC = "synthetic:authors=256,papers=448,venues=10,seed=0"
K = 5


def _oracle(spec=SPEC):
    """A single f64 service on the workers' graph (serve's default
    headroom, as every worker reserves it)."""
    hin = build_worker_hin(spec, 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    return PathSimService(create_backend("numpy", hin, mp),
                          config=ServeConfig(max_wait_ms=0.5, warm=False))


def _assert_oracle(oracle, answers, k=K):
    for row, resp in answers:
        want = [{"id": i, "label": lab, "score": s}
                for i, lab, s in oracle.topk(row=row, k=k)]
        assert resp["result"]["topk"] == want, row


def test_router_smoke(monkeypatch):
    """The port harness's router regime (``bench_serving.run_router_smoke``)
    with ``torch`` workers on the CPU. Every load run it makes is watched
    (its answers, the workers' states and compiles after it), so beyond
    the smoke's own checks every answer is held against the oracle."""
    runs = []
    real = bs.run_router_clients

    def watched(router, schedule, k, **kw):
        res = real(router, schedule, k, **kw)
        runs.append({
            "res": res,
            "status": {wid: w.status for wid, w in router.workers.items()},
            "compiles": bs._router_worker_compiles(router),
        })
        return res

    monkeypatch.setattr(bs, "run_router_clients", watched)
    oracle = _oracle()
    try:
        result = bs.run_router_smoke(platform="cpu")
        assert all(result["smoke_checks"].values()), result["smoke_checks"]
        # replicas 1 and 2 (warm, then measured), then the kill phase
        assert len(runs) == 6
        warm, kill = runs[-2], runs[-1]
        res = kill["res"]
        assert warm["res"]["lost"] == 0, warm["res"]["errors"]
        assert res["lost"] == 0, res["errors"]
        assert result["failover"]["lost"] == 0
        assert res["queries"] == 6 * 16 * 6
        assert kill["status"] == {"w0": "down", "w1": "up"}
        # the kill orphaned in-flight work that completed elsewhere
        assert res["failover_affected"] > 0
        assert result["failover"]["failover_affected"] > 0
        for run in runs:
            _assert_oracle(oracle, run["res"]["answers"])
        assert kill["compiles"] == {"w1": warm["compiles"]["w1"]}
    finally:
        oracle.close()


@pytest.mark.chaos
def test_chaos_router_smoke():
    hin = build_worker_hin(SPEC, 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    transports = {
        f"w{i}": InprocTransport(f"w{i}", WorkerRuntime(PathSimService(
            create_backend("torch", hin, mp, device="cpu"),
            config=ServeConfig(max_batch=8, max_wait_ms=1.0, warm=False)),
            f"w{i}"))
        for i in range(3)
    }
    oracle = _oracle()
    inject.install_plan(",".join([
        "worker_dispatch:error:3",
        "worker_dispatch:delay:1:0.05",
        "heartbeat:error:2",
        "delta_broadcast:error:1@1",
    ]))
    router = Router(transports, RouterConfig(hedge_ms=80.0))
    try:
        router.start()
        futs = [router.submit({"id": i, "op": "topk", "row": i % 256,
                               "k": K}) for i in range(40)]
        upd = {"id": 100, "op": "update",
               "add_edges": [{"rel": "author_of", "src_row": 8,
                              "dst_row": 12}]}
        uresp = router.request(dict(upd), timeout=30)
        assert uresp["ok"], uresp
        # the injected broadcast miss: one replica lags, the others apply
        assert len(uresp["result"]["applied"]) == 2
        assert len(uresp["result"]["lagging"]) == 1
        assert handle_request(oracle, dict(upd))["ok"]
        transports["w2"].kill()  # and THEN a worker dies
        resps = [f.result(timeout=30) for f in futs]
        assert all(r["ok"] for r in resps), [r for r in resps
                                             if not r["ok"]][:3]
        hits = inject.get_injector().hits
        assert hits["worker_dispatch"] >= 40 and hits["delta_broadcast"] == 3
        for row in (8, 12, 50, 100):
            r = router.request({"id": 1, "op": "topk", "row": row, "k": K},
                               timeout=30)
            assert r["ok"], r
            _assert_oracle(oracle, [(row, r)])
    finally:
        inject.reset()
        router.close()
        oracle.close()
        for t in transports.values():
            t.runtime.service.close()
