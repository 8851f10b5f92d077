"""The f32 exact-count guard never latches in the port, and an update that
would trip it is refused with everything left as it was.

The dense backend runs the guard on the host row sums before it caches
them, so every call on a graph past 2^24 raises, not only the first. A
service ``update`` whose patched graph would pass the guard raises
OverflowError before the factor is touched: backend, C, row sums, graph,
denominators, consistency token and both cache tiers stay as they were,
on the patch path and on the rebuild path alike; a router reports such
an update as applied on no replica, with no replica lagging and the
fleet epoch unchanged. The JAX package keeps the latch (it patches, then
raises), so nothing here is held against it."""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    Router,
    RouterConfig,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request
from torch_port_util import overflow_hins

# Two authors at one venue: author 0 writes 3000 papers, author 1 2500,
# so the row sums are 16.5M and 13.75M, below 2^24 = 16,777,216.
COUNTS = [[3000], [2500]]


def _graph(headroom=0.25):
    _, thin = overflow_hins(COUNTS)
    return tdl.with_headroom(thin, headroom) if headroom else thin


def _service(hin, delta_threshold=0.05):
    mp = compile_metapath("APVPA", hin.schema)
    return PathSimService(
        create_backend("torch", hin, mp, device="cpu"),
        config=ServeConfig(max_batch=4, warm=False,
                           delta_threshold=delta_threshold))


def _tripping_records(hin):
    """100 papers of author 1 gain author 0 too: row 0's row sum becomes
    3100 x 5600 = 17.36M, past 2^24."""
    papers = hin.blocks["author_of"].cols[hin.blocks["author_of"].rows == 1]
    return {"add_edges": [{"rel": "author_of", "src_row": 0,
                           "dst_row": int(p)} for p in papers[:100]]}


def test_guard_raises_on_every_call():
    """The paths that carry counts in f32 raise on every call and cache
    nothing; the row sums themselves are exact past 2^24 (f64), so
    ``global_walks`` answers them, and the guarded paths still raise
    after it."""
    hin = _graph(headroom=0)
    mp = compile_metapath("APVPA", hin.schema)
    backend = create_backend("torch", hin, mp, device="cpu")
    np.testing.assert_array_equal(backend.global_walks(),
                                  [16_500_000, 13_750_000])
    _, over = overflow_hins([[4100], [100]])  # 4100 x 4200 = 17.22M
    for call, args in (("commuting_matrix", ()), ("diagonal", ()),
                       ("_denominators", ("rowsum",)),
                       ("pairwise_row", (0,))):
        b = create_backend("torch", over, compile_metapath(
            "APVPA", over.schema), device="cpu")
        for _ in range(2):  # the second call must raise again
            with pytest.raises(OverflowError, match="2\\^24"):
                getattr(b, call)(*args)
        assert b._rowsums is None and b._m is None
        np.testing.assert_array_equal(b.global_walks(),
                                      [17_220_000, 420_000])
        with pytest.raises(OverflowError, match="2\\^24"):
            getattr(b, call)(*args)


def _state(svc):
    c, rowsums = svc.backend._half()
    return {
        "backend": svc.backend, "hin": svc.hin, "c": c.clone(),
        "rowsums": rowsums.clone(), "d": svc._d.copy(), "n": svc.n,
        "token": svc.consistency_token, "fp": svc._fp,
        "row_ver": svc._row_ver.copy(),
        "results": list(svc.result_cache._d),
        "tiles": {k: sorted(v) for k, v in svc.tile_cache._tiles.items()},
        "tile_bytes": svc.tile_cache.bytes_used,
    }


def _assert_state(svc, before):
    after = _state(svc)
    for key in ("backend", "hin"):
        assert after[key] is before[key], key
    assert torch.equal(after["c"], before["c"])
    assert torch.equal(after["rowsums"], before["rowsums"])
    np.testing.assert_array_equal(after["d"], before["d"])
    np.testing.assert_array_equal(after["row_ver"], before["row_ver"])
    for key in ("n", "token", "fp", "results", "tiles", "tile_bytes"):
        assert after[key] == before[key], key


@pytest.mark.parametrize("threshold", [0.05, 0.001],
                         ids=["patch-path", "rebuild-path"])
def test_tripping_update_is_refused_and_changes_nothing(threshold):
    # 100 of 11000 edges: past a 0.1% threshold the update rebuilds
    svc = _service(_graph(), delta_threshold=threshold)
    try:
        answers = {r: svc.topk_index(r, 1) for r in (0, 1)}
        scores = svc.scores_index(0)
        before = _state(svc)
        assert before["results"] and before["tiles"]
        resp = handle_request(svc, {"id": 1, "op": "update",
                                    **_tripping_records(svc.hin)})
        assert not resp["ok"] and "2^24" in resp["error"], resp
        _assert_state(svc, before)
        hits = svc.result_cache.hits
        for r, (v, i) in answers.items():
            got = svc.topk_index(r, 1)
            np.testing.assert_array_equal(got[0], v)
            np.testing.assert_array_equal(got[1], i)
        assert svc.result_cache.hits == hits + 2
        np.testing.assert_array_equal(svc.scores_index(0), scores)
        # the service still takes an update that stays under the guard
        ok = handle_request(svc, {"id": 2, "op": "update", "remove_edges": [
            {"rel": "author_of", "src_row": 1,
             "dst_row": int(svc.hin.blocks["author_of"].cols[-1])}]})
        assert ok["ok"] and ok["result"]["delta_seq"] == 1, ok
    finally:
        svc.close()


def test_router_reports_a_refused_update_with_no_replica_lagging():
    hin = _graph()
    transports = {f"w{i}": InprocTransport(
        f"w{i}", WorkerRuntime(_service(hin), f"w{i}")) for i in range(2)}
    router = Router(transports, RouterConfig(
        hedge_ms=None, scrape_interval_s=0.0, heartbeat_interval_s=0.5,
        heartbeat_miss_limit=40))
    router.start()
    try:
        before = router.request({"op": "topk", "row": 0, "k": 1},
                                timeout=60)
        resp = router.request({"id": 9, "op": "update",
                               **_tripping_records(hin)}, timeout=60)
        assert not resp["ok"], resp
        assert "applied on no replica" in resp["error"]
        assert "2^24" in resp["error"]
        assert resp["detail"]["applied"] == []
        assert resp["detail"]["lagging"] == []
        assert sorted(resp["detail"]["missed"]) == ["w0", "w1"]
        assert len(router._epochs) == 1  # the fleet epoch did not move
        for t in transports.values():
            assert t.runtime.service.consistency_token == (
                router._epochs[0].token)
        workers = router.stats()["router"]["workers"]
        assert all(w["lag"] == 0 for w in workers.values())
        # with both cache tiers dropped, row 0 is recomputed from C
        assert router.request({"op": "invalidate"}, timeout=60)["ok"]
        after = router.request({"op": "topk", "row": 0, "k": 1}, timeout=60)
        assert after["ok"] and after["result"] == before["result"]
    finally:
        router.close()
        for t in transports.values():
            t.runtime.service.close()
