"""The ANN tier behind the port's router, on the CPU — twins of the JAX
package's router-side ANN tests:

- the router CLI forwards the ANN flags to its worker children as the
  JAX router does (tests/test_index.py), and the same flags configure an
  in-process service;
- the only ANN-indexed replica killed mid-batch: every in-flight
  ``"mode": "ann"`` request re-dispatches onto an exact-only replica and
  is answered exactly — 0 lost, answers equal to the oracle, the
  survivor's responses annotated ``ann_fallback: no_index`` and kept by
  the flight recorder; ``health`` / ``stats()`` carry each replica's
  index epoch (tests/test_router.py);
- the background re-embed after an update runs as its own ``ann.refresh``
  trace whose root links the update's span, the index spans under it
  (tests/test_fleet_obs.py).
"""

import time

import numpy as np
import pytest

from distributed_pathsim_tpu.router.cli import _worker_argv as j_worker_argv
from distributed_pathsim_tpu.router.cli import build_router_parser as jparser
from distributed_pathsim_tpu_torch import obs
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
from distributed_pathsim_tpu_torch.router.cli import (
    _worker_argv,
    parse_router_args,
)
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.cli import serve_config
from distributed_pathsim_tpu_torch.serving.protocol import handle_request

ANN_FLAGS = ["--topk-mode", "ann", "--index", "idx.npz", "--ann-nprobe",
             "4", "--ann-cand-mult", "8", "--ann-centroids", "12",
             "--ann-cluster-cap", "24", "--ann-variant", "shortlist",
             "--ann-shadow-every", "3", "--no-ann-refresh"]


def _ann_part(argv):
    """The ANN flags of a worker command line, flag → value."""
    out = {}
    for i, tok in enumerate(argv):
        if tok in ("--topk-mode", "--index") or tok.startswith("--ann-"):
            out[tok] = argv[i + 1]
        elif tok == "--no-ann-refresh":
            out[tok] = True
    return out


def test_ann_flags_forward_as_jax_and_configure_services():
    common = ["--workers", "2", "--dataset", "g.gexf"]
    targs = parse_router_args([*common, *ANN_FLAGS, "--platform", "cpu"])
    jargs = jparser().parse_args([*common, *ANN_FLAGS])
    for i in range(2):
        got = _ann_part(_worker_argv(targs, i))
        assert got == _ann_part(j_worker_argv(jargs, i))
        assert got["--topk-mode"] == "ann" and got["--ann-nprobe"] == "4"
        assert got["--no-ann-refresh"] is True
    cfg = serve_config(targs)
    assert (cfg.topk_mode, cfg.index_path, cfg.ann_nprobe, cfg.ann_cand_mult,
            cfg.ann_centroids, cfg.ann_cluster_cap, cfg.ann_variant,
            cfg.ann_shadow_every, cfg.ann_auto_refresh) == (
        "ann", "idx.npz", 4, 8, 12, 24, "shortlist", 3, False)
    # the defaults: exact, nothing forwarded but the mode
    plain = parse_router_args(common)
    assert _ann_part(_worker_argv(plain, 0)) == {
        "--topk-mode": "exact", "--ann-shadow-every": "64"}
    assert serve_config(plain).ann_auto_refresh is True


def _fallbacks(reason):
    return get_registry().counter(
        "dpathsim_ann_fallbacks_total",
        "ann-requested queries answered exactly instead, by reason",
    ).labels(reason=reason).value


@pytest.mark.chaos
def test_ann_failover_to_an_exact_only_replica():
    hin = with_headroom(synthetic_hin(140, 230, 8, seed=11), 0.25)
    mp = compile_metapath("APVPA", hin.schema)

    def _svc(ann: bool):
        return PathSimService(
            create_backend("torch", hin, mp, device="cpu"),
            config=ServeConfig(max_wait_ms=1.0, warm=False,
                               topk_mode="ann" if ann else "exact",
                               ann_shadow_every=0, compact_auto=False))

    oracle = _svc(False)
    inject.install_plan("heartbeat:error:2")
    transports = {
        "w0": InprocTransport("w0", WorkerRuntime(_svc(True), "w0")),
        "w1": InprocTransport("w1", WorkerRuntime(_svc(False), "w1")),
    }
    router = Router(transports, RouterConfig(heartbeat_interval_s=0.05,
                                             hedge_ms=None))
    router.start()
    try:
        h0, h1 = router.worker_health("w0"), router.worker_health("w1")
        assert h0["index"]["mode"] == "ann" and h1["index"] is None
        assert h0["index"]["epoch"] == list(
            transports["w0"].runtime.service.consistency_token)
        assert h0["modes"]["ann"]["epoch"] == h0["index"]["epoch"]
        assert h1["modes"]["ann"] is None
        st = router.stats()["router"]["workers"]
        assert st["w0"]["index"]["epoch"] == h0["index"]["epoch"]
        assert st["w1"]["index"] is None
        no_index0 = _fallbacks("no_index")
        futs = [router.submit({"id": i, "op": "topk", "row": i % oracle.n,
                               "k": 5, "mode": "ann"}) for i in range(48)]
        transports["w0"].kill()  # the indexed replica dies mid-batch
        resps = [f.result(timeout=30) for f in futs]
        assert all(r["ok"] for r in resps)
        for i, r in enumerate(resps):
            assert r["result"]["topk"] == [
                {"id": a, "label": lab, "score": s}
                for a, lab, s in oracle.topk(row=i % oracle.n, k=5)], i
        assert st and router.stats()["router"]["workers"]["w0"][
            "status"] == "down"
        assert sum(1 for r in resps if r.get("failovers")) > 0
        survivor = [r for r in resps if r["result"].get("ann_fallback")]
        assert survivor and all(r["result"]["ann_fallback"] == "no_index"
                                for r in survivor)
        assert _fallbacks("no_index") - no_index0 >= len(survivor)
        kept = [rec for rec in router.flight.records()
                if "ann_fallback" in rec["reasons"]]
        assert kept and all(rec["ann_fallback"] == "no_index"
                            for rec in kept)
    finally:
        inject.reset()
        router.close()
        oracle.close()
        for t in transports.values():
            t.runtime.service.close()


@pytest.fixture()
def tracing():
    obs.configure(metrics=True, tracing=True, trace_sample=1)
    obs.get_tracer().clear()
    yield obs.get_tracer()
    obs.configure(metrics=True, tracing=False, trace_sample=1)
    obs.get_tracer().clear()


def _wait_for(tracer, name):
    for _ in range(500):
        spans = [s for s in tracer.spans() if s.name == name]
        if spans:
            return spans[0]
        time.sleep(0.01)
    raise AssertionError(f"no {name} span")


def test_ann_refresh_emits_a_linked_root_span(tracing):
    small = with_headroom(synthetic_hin(64, 100, 4, seed=3), 0.25)
    mp = compile_metapath("APVPA", small.schema)
    service = PathSimService(
        create_backend("torch", small, mp, device="cpu"),
        config=ServeConfig(max_wait_ms=1.0, warm=False, topk_mode="ann",
                           ann_shadow_every=0, compact_auto=False))
    try:
        ap = service.hin.blocks["author_of"]
        resp = handle_request(service, {
            "id": 1, "op": "update", "remove_edges": [{
                "rel": "author_of", "src_row": int(ap.rows[0]),
                "dst_row": int(ap.cols[0])}],
        })
        assert resp["ok"] and resp["result"]["mode"] == "delta"
        assert resp["result"]["ann_stale_rows"] > 0
        refresh = _wait_for(tracing, "ann.refresh")
        op_span = next(s for s in tracing.spans()
                       if s.name == "serve.op" and s.args.get("op") == "update")
        assert refresh.args["link"] == f"{op_span.trace_id}:{op_span.span_id}"
        assert refresh.trace_id != op_span.trace_id  # its own trace
        _wait_for(tracing, "index.refresh_rows")
        embed = _wait_for(tracing, "index.refresh_embed")
        assert embed.trace_id == refresh.trace_id
        for _ in range(500):  # the thread hands its debounce flag back
            if not service._ann_refresh_inflight:
                break
            time.sleep(0.01)
        assert service._ann.index.stale_count == 0
        assert service.health()["index"]["epoch"] == list(
            service.consistency_token)
    finally:
        service.close()
