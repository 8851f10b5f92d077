"""The learned tier behind the port's router under a kill, on the CPU —
the ``chaos`` twin of tests/test_router.py's learned failover: the only
tower-ed replica killed mid-batch, every in-flight ``"mode": "learned"``
request re-dispatched onto a replica with no towers at all and answered
exactly — 0 lost, answers equal to the f64 oracle's, the survivor's
``no_towers`` fallbacks counted — and ``health`` / ``stats()`` carrying
each replica's per-mode epoch map."""

import numpy as np
import pytest

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.delta import with_headroom
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.obs.metrics import get_registry
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.resilience import inject
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig


def _no_towers() -> float:
    return get_registry().counter(
        "dpathsim_learned_fallbacks_total",
        "learned-requested queries degraded to ann/exact, by reason",
    ).labels(reason="no_towers").value


def _oracle_topk(oracle, row: int, k: int):
    vals, idxs = oracle.topk_index(int(row), k)
    return [(oracle._ident(int(j))[0], float(v))
            for v, j in zip(vals, idxs) if np.isfinite(v)]


@pytest.mark.chaos
def test_router_learned_failover_to_a_towerless_replica():
    hin = with_headroom(synthetic_hin(140, 230, 8, seed=11), 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    inject.install_plan("heartbeat:error:2")

    def _svc(learned: bool):
        return PathSimService(
            create_backend("torch", hin, mp, device="cpu"),
            config=ServeConfig(
                max_wait_ms=1.0, warm=False,
                topk_mode="learned" if learned else "exact",
                learned_shadow_every=0, learned_auto_refresh=False,
                # a candidate set >= n: learned answers are bit-identical
                # whatever 40 steps taught the towers
                learned_cand_mult=32, learned_steps=40,
            ),
        )

    oracle = PathSimService(create_backend("numpy", hin, mp),
                            config=ServeConfig(max_wait_ms=1.0, warm=False))
    transports = {
        "w0": InprocTransport("w0", WorkerRuntime(_svc(True),
                                                  worker_id="w0")),
        "w1": InprocTransport("w1", WorkerRuntime(_svc(False),
                                                  worker_id="w1")),
    }
    router = Router(transports, RouterConfig(heartbeat_interval_s=0.05,
                                             hedge_ms=None))
    router.start()
    try:
        h0 = router.worker_health("w0")
        h1 = router.worker_health("w1")
        token0 = list(transports["w0"].runtime.service.consistency_token)
        assert h0["modes"]["learned"]["epoch"] == token0
        assert h0["modes"]["learned"]["enabled"]
        assert h0["modes"]["exact"]["epoch"] == token0
        assert h1["modes"]["learned"] is None
        assert h1["modes"]["exact"]["enabled"]
        st = router.stats()["router"]["workers"]
        assert st["w0"]["modes"]["learned"]["epoch"] == token0
        assert st["w1"]["modes"]["learned"] is None

        fb0 = _no_towers()
        futs = [router.submit({"id": i, "op": "topk", "row": int(i % oracle.n),
                               "k": 5, "mode": "learned"})
                for i in range(48)]
        transports["w0"].kill()  # the tower-ed replica dies mid-batch
        resps = [fut.result(timeout=30) for fut in futs]
        assert all(r["ok"] for r in resps)
        for i, r in enumerate(resps):
            got = [(h["id"], h["score"]) for h in r["result"]["topk"]]
            assert got == _oracle_topk(oracle, i % oracle.n, 5), i
        assert router.stats()["router"]["workers"]["w0"]["status"] == "down"
        # the kill orphaned real learned work onto the survivor, where
        # each answer is a counted no_towers fallback
        assert sum(1 for r in resps if r.get("failovers")) > 0
        assert _no_towers() > fb0
    finally:
        inject.reset()
        router.close()
        oracle.close()
        for t in transports.values():
            t.runtime.service.close()
