"""Port parity of the router tier's host modules against the JAX package:
the routing policies' preference lists (consistent-hash ring and row
ranges), the row-range PartitionMap and its slicing helpers, the
firehose coalescing of queued updates, the fault-plan grammar, and the
obs exporters (Prometheus text of one registry, the exact fleet merge,
the fleet Prometheus text and the ``fleet-stats`` rendering). Same
inputs, identical outputs."""

import numpy as np
import pytest

from distributed_pathsim_tpu.data import partition as jpart
from distributed_pathsim_tpu.obs import export as jexport
from distributed_pathsim_tpu.obs import fleet as jfleet
from distributed_pathsim_tpu.obs import metrics as jmetrics
from distributed_pathsim_tpu.resilience import inject as jinject
from distributed_pathsim_tpu.router import firehose as jfirehose
from distributed_pathsim_tpu.router import hashring as jring
from distributed_pathsim_tpu_torch.data import partition as tpart
from distributed_pathsim_tpu_torch.obs import export as texport
from distributed_pathsim_tpu_torch.obs import fleet as tfleet
from distributed_pathsim_tpu_torch.obs import metrics as tmetrics
from distributed_pathsim_tpu_torch.resilience import inject as tinject
from distributed_pathsim_tpu_torch.router import firehose as tfirehose
from distributed_pathsim_tpu_torch.router import hashring as tring
from torch_port_util import delta_graphs


@pytest.mark.parametrize("routing", ["hash", "range"])
def test_preference_lists_match_jax(routing):
    keys = list(range(0, 1000, 7)) + ["Didier Dubois", "author_17", ""]
    for workers in (["w0"], ["w0", "w1"], ["w2", "w0", "w1"],
                    [f"w{i}" for i in range(5)]):
        jp = jring.make_policy(routing, workers, n_rows=997, vnodes=16)
        tp = tring.make_policy(routing, workers, n_rows=997, vnodes=16)
        assert tp.workers == jp.workers
        for key in keys:
            assert tp.preference(key) == jp.preference(key), (workers, key)
            assert tp.owner(key) == jp.owner(key)
        for gone in workers[:-1]:
            jw, tw = jp.without(gone), tp.without(gone)
            assert [tw.preference(k) for k in keys] == [
                jw.preference(k) for k in keys]
        if routing == "range":
            for wid in workers:
                assert tp.range_of(wid) == jp.range_of(wid)
            for row in (0, 1, 498, 996):
                assert tp.owner_of(row) == jp.owner_of(row)
    # the 64-bit ring point itself
    for s in ("row:0", "w1#63", "label:x"):
        assert tring._h64(s) == jring._h64(s)


def test_partition_map_and_slicing_match_jax():
    for n, p in ((10, 3), (7, 7), (3, 5), (1000, 4)):
        jm, tm = jpart.PartitionMap(n=n, p=p), tpart.PartitionMap(n=n, p=p)
        assert tm.span == jm.span and tm.ranges() == jm.ranges()
        for r in (1, 2, 3):
            for g in range(p):
                assert tm.held_by(g, r) == jm.held_by(g, r)
                assert tm.holders_of(g, r) == jm.holders_of(g, r)
                assert tm.rows_held(g, r) == jm.rows_held(g, r)
        for row in range(0, n, max(n // 13, 1)):
            assert tm.owner_of(row) == jm.owner_of(row)
    with pytest.raises(ValueError):
        tpart.PartitionMap(n=4, p=0)
    jhin, thin = delta_graphs()
    ranges = ((0, 20), (50, 70))
    js = jpart.slice_hin(jhin, "author", ranges)
    ts = tpart.slice_hin(thin, "author", ranges)
    for rel in jhin.blocks:
        np.testing.assert_array_equal(ts.blocks[rel].rows, js.blocks[rel].rows)
        np.testing.assert_array_equal(ts.blocks[rel].cols, js.blocks[rel].cols)
    adds = [{"rel": "author_of", "src_row": r, "dst_row": 3}
            for r in (1, 30, 55)]
    adds.append({"rel": "submit_at", "src_row": 2, "dst_row": 1})
    rems = [{"rel": "author_of", "src": thin.indices["author"].ids[60],
             "dst": thin.indices["paper"].ids[0]}]
    assert tpart.filter_axis_edges(thin, "author", ranges, adds, rems) == (
        jpart.filter_axis_edges(jhin, "author", ranges, adds, rems))


def _update(i, add=(), remove=(), nodes=()):
    def rec(e):
        src, dst = e
        key = "src" if isinstance(src, str) else "src_row"
        return {"rel": "author_of", key: src, "dst_row": dst}
    return {"id": i, "op": "update",
            "add_nodes": [{"type": "author", "id": n} for n in nodes],
            "add_edges": [rec(e) for e in add],
            "remove_edges": [rec(e) for e in remove]}


def test_coalesced_update_groups_match_jax():
    reqs = [
        _update(1, add=[(1, 2), (3, 4)]),
        _update(2, remove=[(1, 2)]),            # cancels 1's add
        _update(3, add=[(3, 4)]),               # add→add: a new group
        _update(4, nodes=["a_new"], add=[("a_new", 5)]),
        _update(5, nodes=["a_new"]),            # id appended twice: split
        _update(6, add=[(7, 7), (7, 7)]),       # self-conflicting
        _update(7, remove=[(8, 9)]),
        _update(8, add=[(8, 9)]),
    ]
    for max_group in (1, 2, 8):
        jg = jfirehose.coalesce_update_groups(reqs, max_group)
        tg = tfirehose.coalesce_update_groups(reqs, max_group)
        assert [[m["id"] for m in g.members] for g in tg] == [
            [m["id"] for m in g.members] for g in jg]
        assert [g.merged_wire for g in tg] == [g.merged_wire for g in jg]


@pytest.mark.parametrize("plan", [
    "worker_dispatch:error:3,worker_dispatch:delay:1:0.05,"
    "heartbeat:error:2,delta_broadcast:error:1@1",
    " tile_execute:crash:1@2 , checkpoint_write:partial, gexf_load:preempt",
    "no_such_seam:delay::0.5,worker_dispatch:error",
    "worker_dispatch:explode:1",
    "heartbeat",
])
def test_fault_plan_parsing_matches_jax(plan):
    def parse(mod):
        try:
            return [vars(r) for r in mod.parse_plan(plan)]
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert parse(tinject) == parse(jinject)
    assert tinject.SEAMS == jinject.SEAMS


def _fill(mod, seed):
    """One registry of each package, filled with the same observations."""
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    c = reg.counter("dpathsim_router_requests_total", "router requests")
    g = reg.gauge("dpathsim_update_queue_depth", "queued updates")
    h = reg.histogram("dpathsim_router_request_seconds", "latency")
    for v in rng.exponential(0.01, 200):
        c.inc(outcome="ok" if v < 0.02 else "error")
        h.observe(float(v), outcome="ok")
    h.observe(0.0, outcome="shed")
    h.observe(1e9, outcome="shed")
    g.set(float(seed) + 0.5)
    reg.counter("dpathsim_weird", 'quote " and \\ backslash').inc(
        path='a"b\\c\nd')
    return reg


def test_prometheus_text_and_fleet_merge_match_jax():
    for seed in (0, 1):
        assert texport.render_prometheus(_fill(tmetrics, seed)) == (
            jexport.render_prometheus(_fill(jmetrics, seed)))
    tparts = {w: _fill(tmetrics, i).snapshot()
              for i, w in enumerate(("router", "w0", "w1"))}
    jparts = {w: _fill(jmetrics, i).snapshot()
              for i, w in enumerate(("router", "w0", "w1"))}
    assert tfleet.merge_registry_snapshots(tparts) == (
        jfleet.merge_registry_snapshots(jparts))
    assert tfleet.render_fleet_prometheus(tparts) == (
        jfleet.render_fleet_prometheus(jparts))
    merged, _ = tfleet.merge_registry_snapshots(tparts)
    data = {
        "router": {"workers": {
            "w0": {"status": "up", "queue_depth": 3, "assigned": 1,
                   "epoch": 2, "lag": 0, "token": ["fp", 2]},
            "w1": {"status": "down", "queue_depth": 0, "assigned": 0,
                   "epoch": 1, "lag": 1, "token": ["fp", 1]}},
            "routing": "hash", "epochs": 3, "pending": 1},
        "merged": merged, "unmergeable": [],
        "scrape_age_s": {"w0": 0.5, "w1": None},
        "slo": {}, "flight": {"kept_total": 2, "dropped": 0,
                              "capacity": 256},
    }
    assert tfleet.render_fleet_stats(data) == jfleet.render_fleet_stats(data)
