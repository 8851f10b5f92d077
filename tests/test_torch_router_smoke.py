"""Port twins of the JAX package's router smokes, on the CPU.

- ``test_router_smoke``: two real ``dpathsim-torch worker`` subprocesses
  (``--platform cpu``), closed-loop load, one SIGKILL mid-load — zero
  lost requests, every answer equal to a single f64 (numpy) service's,
  a failover counted, zero compiles added on the survivor
  (tests/test_router.py::test_bench_router_smoke).
- ``test_chaos_router_smoke``: three in-process workers under a fault
  plan (transient dispatch errors, a stall, dropped heartbeats, a missed
  delta broadcast) and a kill — zero lost, every answer oracle-exact
  before and after the update (::test_chaos_router_smoke). The plan is
  installed here and removed in ``finally``, so none leaks into another
  test file on the same worker process.
"""

import sys
import threading
import time

import numpy as np
import pytest

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.resilience import inject
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    SubprocessTransport,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.router.cli import build_worker_hin
from distributed_pathsim_tpu_torch.router.loadgen import run_router_clients
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


def _worker_argv(wid):
    return [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
            "worker", "--worker-id", wid, "--dataset", SPEC, "--backend",
            "torch", "--platform", "cpu", "--max-batch", "8",
            "--max-wait-ms", "1.0", "--k", str(K)]


def _compiles(router):
    return {wid: int(router.worker_health(wid).get("compiles", 0))
            for wid, w in router.workers.items() if w.status == "up"}


def test_router_smoke():
    transports = {f"w{i}": SubprocessTransport(f"w{i}", _worker_argv(f"w{i}"))
                  for i in range(2)}
    router = Router(transports, RouterConfig(
        heartbeat_interval_s=0.2, heartbeat_miss_limit=15, hedge_ms=300.0,
        max_inflight=4096))
    oracle = _oracle()
    rng = np.random.default_rng(0)
    uniform = rng.integers(0, 256, size=(6, 16))
    try:
        router.start(ready_timeout=120)
        warm = run_router_clients(router, uniform[:4, :8].tolist(), K)
        assert warm["lost"] == 0, warm["errors"]
        h0 = _compiles(router)
        started = threading.Event()

        def killer():
            started.wait()
            time.sleep(0.05)  # mid-load: in-flight work must be orphaned
            transports["w0"].kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        started.set()
        res = run_router_clients(router, np.tile(uniform, (1, 6)).tolist(), K)
        kt.join(timeout=30)
        assert res["lost"] == 0, res["errors"]
        assert res["queries"] == 6 * 16 * 6
        assert router.workers["w0"].status == "down"
        assert router.workers["w1"].status == "up"
        # the kill orphaned in-flight work that completed elsewhere
        assert res["failover_affected"] > 0
        _assert_oracle(oracle, warm["answers"] + res["answers"])
        after = _compiles(router)
        assert after == {"w1": h0["w1"]}
    finally:
        router.close()
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
