"""The port's serving layer on the CPU: the coalescer (concurrent
submitters, load shedding), both cache tiers (hits, other-k re-select,
reload, row purges), the bucket ladder and warmup, and the compile
counter — the JAX package's serving tests, run against the port, with
answers held to the JAX package's numpy oracle."""

import json
import threading
import time

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.tuning import registry as jreg
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import (
    LoadShedError,
    PathSimService,
    ServeConfig,
    graph_fingerprint,
)
from distributed_pathsim_tpu_torch.serving import buckets as bk
from distributed_pathsim_tpu_torch.serving.cache import (
    HotTileCache,
    ResultCache,
)
from distributed_pathsim_tpu_torch.utils import compile_counter
from distributed_pathsim_tpu_torch.utils.logging import (
    RunLogger,
    set_event_sink,
)
from torch_port_util import backend_graphs


@pytest.fixture(scope="module")
def graphs():
    return backend_graphs()


@pytest.fixture(scope="module")
def oracle(graphs):
    jhin, _ = graphs
    return jcreate("numpy", jhin, jmeta.compile_metapath("APVPA", jhin.schema))


def _service(graphs, backend_name="torch", **cfg):
    _, thin = graphs
    cfg.setdefault("max_wait_ms", 5.0)
    cfg.setdefault("warm", False)  # per-test services: skip warm loops
    opts = {"device": "cpu"} if backend_name != "numpy" else {}
    backend = create_backend(backend_name, thin,
                             compile_metapath("APVPA", thin.schema), **opts)
    return PathSimService(backend, config=ServeConfig(**cfg))


def test_coalescer_concurrent_submitters_route_correctly(graphs, oracle):
    """Concurrent clients through one service: every future resolves to
    ITS row's oracle answer, and coalescing actually happened."""
    svc = _service(graphs, "torch", max_batch=8, cache_entries=0,
                   tile_cache_bytes=0)
    try:
        rows = [i % 60 for i in range(48)]  # includes duplicates
        results: dict[int, tuple] = {}

        def worker(slot, r):
            results[slot] = svc.topk_index(r, k=6)

        threads = [threading.Thread(target=worker, args=(slot, r))
                   for slot, r in enumerate(rows)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for slot, r in enumerate(rows):
            ov, oi = oracle.topk_row(r, k=6)
            av, ai = results[slot]
            np.testing.assert_array_equal(av, ov)
            np.testing.assert_array_equal(ai, oi)
        st = svc.stats()["dispatch"]
        assert st["requests"] == len(rows)
        assert st["batches"] < len(rows)  # some coalescing happened
        assert st["shed"] == 0
    finally:
        svc.close()


def test_load_shedding_at_queue_bound(graphs, tmp_path):
    """A full queue sheds immediately with a structured event; admitted
    requests still complete correctly."""
    svc = _service(graphs, "numpy", max_batch=1, max_wait_ms=0.0,
                   queue_depth=2, cache_entries=0, tile_cache_bytes=0)
    real = svc.backend.pairwise_rows

    def slow(rows):  # every dispatch slow, so the queue backs up
        time.sleep(0.05)
        return real(rows)

    svc.backend.pairwise_rows = slow
    metrics = tmp_path / "events.jsonl"
    logger = RunLogger(output_path=None, echo=False, metrics_path=str(metrics))
    set_event_sink(logger)
    try:
        futures, shed = [], 0
        for i in range(20):
            try:
                futures.append((i, svc.submit_topk(i, k=3)))
            except LoadShedError:
                shed += 1
        assert shed > 0
        assert svc.stats()["dispatch"]["shed"] == shed
        for i, fut in futures:
            vals, idxs = fut.result(timeout=30)
            sv, si = svc.backend.topk_row(i, k=3)
            assert np.array_equal(vals, sv) and np.array_equal(idxs, si)
    finally:
        set_event_sink(None)
        logger.close()
        svc.close()
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    sheds = [e for e in events if e["event"] == "serve_shed"]
    assert sheds and sheds[0]["depth"] == 2


def test_result_cache_hit_miss_and_invalidate(graphs):
    svc = _service(graphs, "torch", max_batch=4)
    try:
        v1, i1 = svc.topk_index(7, k=5)
        s = svc.stats()["result_cache"]
        assert s["misses"] >= 1 and s["hits"] == 0
        v2, i2 = svc.topk_index(7, k=5)
        assert svc.stats()["result_cache"]["hits"] == 1
        assert np.array_equal(v1, v2) and np.array_equal(i1, i2)
        svc.invalidate()
        assert len(svc.result_cache) == 0
        v3, _ = svc.topk_index(7, k=5)
        assert np.array_equal(v3, v1)  # same graph → same answer
    finally:
        svc.close()


def test_tile_cache_serves_other_k_without_dispatch(graphs, oracle):
    """Tier 2: a known score row answers a different k with zero new
    dispatches (the k is not in the tile key)."""
    svc = _service(graphs, "torch", max_batch=4)
    try:
        svc.topk_index(11, k=5)
        batches = svc.stats()["dispatch"]["batches"]
        vals, idxs = svc.topk_index(11, k=9)  # larger k: tier-1 miss
        assert svc.stats()["dispatch"]["batches"] == batches
        ov, oi = oracle.topk_row(11, k=9)
        assert np.array_equal(vals, ov) and np.array_equal(idxs, oi)
        assert svc.stats()["tile_cache"]["hits"] >= 1
    finally:
        svc.close()


def test_cache_invalidation_on_graph_reload():
    """Reload with a DIFFERENT graph: fingerprint changes, caches
    cleared, answers come from the new graph."""
    hin_a = synthetic_hin(120, 200, 8, n_topics=3, seed=1)
    hin_b = synthetic_hin(120, 200, 8, n_topics=3, seed=2)
    mp = compile_metapath("APVPA", hin_a.schema)
    assert graph_fingerprint(hin_a) != graph_fingerprint(hin_b)
    svc = PathSimService(create_backend("torch", hin_a, mp, device="cpu"),
                         config=ServeConfig(max_batch=4, warm=False))
    try:
        va, _ = svc.topk_index(5, k=5)
        fp_a = svc.stats()["fingerprint"]
        svc.reload(create_backend("torch", hin_b, mp, device="cpu"))
        assert svc.stats()["fingerprint"] != fp_a
        assert len(svc.result_cache) == 0
        vb, ib = svc.topk_index(5, k=5)
        ov, oi = create_backend("numpy", hin_b, mp).topk_row(5, k=5)
        assert np.array_equal(vb, ov) and np.array_equal(ib, oi)
        assert not np.array_equal(va, vb)  # different graph, new answers
    finally:
        svc.close()


def test_cache_tiers_purge_rows():
    """Row-granular delta invalidation: only the named rows' entries go;
    a tile keeps its surviving rows."""
    c = ResultCache(capacity=32)
    for row in range(8):
        c.put(("fp", "APVPA", "rowsum", 0, row, 5), np.zeros(5), np.arange(5))
    assert c.purge_rows([1, 3, 99]) == 2
    assert len(c) == 6
    assert c.get(("fp", "APVPA", "rowsum", 0, 1, 5)) is None
    assert c.get(("fp", "APVPA", "rowsum", 0, 2, 5)) is not None
    t = HotTileCache(budget_bytes=1 << 20, tile_rows=4)
    epoch = ("fp", "APVPA", "rowsum", 0)
    for row in range(8):
        t.put_row(epoch, row, np.full(10, float(row)))
    before = t.bytes_used
    assert t.purge_rows([1, 5]) == 2
    assert t.get_row(epoch, 1) is None and t.get_row(epoch, 5) is None
    assert t.get_row(epoch, 0) is not None  # tile survives, row by row
    assert t.bytes_used == before - 2 * 80


def test_bucket_ladder_matches_jax():
    for geometry in ("pow2", "coarse"):
        for max_batch in (1, 2, 3, 8, 31, 32, 33, 100):
            assert bk.resolve_ladder(geometry, max_batch) == (
                jreg.resolve_ladder(geometry, max_batch))
    assert bk.bucket_ladder(32) == (1, 2, 4, 8, 16, 32)
    assert bk.bucket_for(5, bk.bucket_ladder(32)) == 8
    np.testing.assert_array_equal(bk.pad_rows(np.array([4, 9, 2]), 4),
                                  [4, 9, 2, 4])
    with pytest.raises(ValueError):
        bk.resolve_ladder("pow2", 0)


def test_warmup_events_and_zero_steady_state_compiles(graphs, tmp_path):
    """Warmup drives every bucket (one compile_warm event each); a warm
    service then answers queries and an update with 0 compiles, while
    the counter does see a recorded build."""
    from distributed_pathsim_tpu_torch.data import delta as tdl

    metrics = tmp_path / "events.jsonl"
    logger = RunLogger(output_path=None, echo=False, metrics_path=str(metrics))
    set_event_sink(logger)
    try:
        _, thin = graphs
        hin = tdl.with_headroom(thin, 0.25)
        mp = compile_metapath("APVPA", hin.schema)
        svc = PathSimService(create_backend("torch", hin, mp, device="cpu"),
                             config=ServeConfig(max_batch=8, max_wait_ms=1.0))
        try:
            with compile_counter.CompileCounter() as cc:
                for r in range(0, 40, 3):
                    svc.topk_index(r, k=5)
                blk = hin.blocks["author_of"]
                svc.update(tdl.DeltaBatch(edges=(tdl.edge_delta(
                    "author_of",
                    remove=[[int(blk.rows[0]), int(blk.cols[0])]]),)))
                svc.topk_index(0, k=5)
            assert cc.count == 0
            total = compile_counter.compiles_total()
            assert svc.health()["compiles"] == total
            with compile_counter.CompileCounter() as cc:
                compile_counter.record("nvcc", "topk_fold")
            assert cc.count == 1 and cc.by_kind == {"nvcc": 1}
            assert svc.health()["compiles"] == total + 1
        finally:
            svc.close()
    finally:
        set_event_sink(None)
        logger.close()
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    warm = [e["bucket"] for e in events if e["event"] == "compile_warm"]
    assert warm == [1, 2, 4, 8]
