"""Partition mode of the port (``backends/partition_factors.py``,
``serving/partition.py``, ``router/partition.py``) against the JAX
package's, the twins of tests/test_partition.py: factor slices equal to
the JAX slices, every partition op's answer equal, and routed ``topk`` /
``scores`` answers bit-identical to the JAX partition router's (and to a
single-host oracle) through random routed deltas, a worker SIGKILLed
mid-batch with 0 lost, a missed broadcast fenced and replayed, and the
``router --mode partition`` CLI. The partition workers run on the host
(``device="cpu"``, the host arm of the window counts)."""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from distributed_pathsim_tpu import router as jrouter
from distributed_pathsim_tpu.backends import partition_factors as jpf
from distributed_pathsim_tpu.data import partition as jpart
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.resilience import inject as jinject
from distributed_pathsim_tpu.serving import partition as jsp
from distributed_pathsim_tpu_torch import router as trouter
from distributed_pathsim_tpu_torch.backends import partition_factors as tpf
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.data import partition as tpart
from distributed_pathsim_tpu_torch.resilience import inject as tinject
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving import partition as tsp
from distributed_pathsim_tpu_torch.serving.protocol import handle_request
from torch_port_util import metapaths, port_hin

REPO = str(pathlib.Path(__file__).resolve().parents[1])
SPEC = dict(n_authors=140, n_papers=230, n_venues=8, seed=11)


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn.synthetic_hin(**SPEC)
    return jhin, port_hin(jhin)


class _Fleets:
    """The same partition fleet in both packages: inproc workers behind
    each package's PartitionRouter."""

    def __init__(self, graphs, partitions, replication=2,
                 factor_format=None):
        jmp, tmp = metapaths(graphs)
        self.routers, self.transports = [], []
        for pkg, hin, mp in ((0, graphs[0], jmp), (1, graphs[1], tmp)):
            sp, rt = (jsp, jrouter) if pkg == 0 else (tsp, trouter)
            cfg = dict(factor_format=factor_format)
            if pkg == 1:
                cfg["device"] = "cpu"
            transports = {
                f"w{i}": rt.InprocTransport(f"w{i}", rt.WorkerRuntime(
                    sp.PartitionService(hin, mp, i, partitions, replication,
                                        config=sp.PartitionConfig(**cfg)),
                    worker_id=f"w{i}"))
                for i in range(partitions)}
            router = rt.PartitionRouter(transports, rt.PartitionRouterConfig(
                partitions=partitions, replication=replication,
                heartbeat_interval_s=0.05))
            router.start()
            self.routers.append(router)
            self.transports.append(transports)

    def both(self, req, timeout=30):
        return [r.request(dict(req), timeout=timeout) for r in self.routers]

    def close(self):
        for r in self.routers:
            r.close()


def _oracle(hin, mp):
    return PathSimService(create_backend("numpy", hin, mp), config=ServeConfig(
        warm=False, max_wait_ms=0.5, delta_threshold=1.0))


def _topk(resp):
    assert resp.get("ok"), resp
    return [(h["id"], h["score"]) for h in resp["result"]["topk"]]


def _oracle_topk(oracle, row, k):
    vals, idxs = oracle.topk_index(int(row), k)
    return [(oracle._ident(int(j))[0], float(v))
            for v, j in zip(vals, idxs) if np.isfinite(v)]


def test_factor_slices_equal_the_jax_slices(graphs):
    jmp, tmp = metapaths(graphs)
    n = graphs[0].type_size("author")
    for fmt in ("coo", "bitpacked"):
        for part in range(3):
            held = tpart.PartitionMap(n=n, p=3).held_by(part, 2)
            jpm, tpm = jpart.PartitionMap(n=n, p=3), tpart.PartitionMap(n=n,
                                                                        p=3)
            ranges = [tpm.range_of(g) for g in held]
            jfs = jpf.build_factor_slice(
                jpart.slice_hin(graphs[0], "author", ranges), jmp, jpm, held,
                factor_format=fmt)
            tfs = tpf.build_factor_slice(
                tpart.slice_hin(graphs[1], "author", ranges), tmp, tpm, held,
                factor_format=fmt)
            np.testing.assert_array_equal(tfs.rows, jfs.rows)
            np.testing.assert_array_equal(tfs.held_slot_of, jfs.held_slot_of)
            assert tfs.range_slots == jfs.range_slots
            np.testing.assert_array_equal(tfs.window_dense(0, tfs.n_held),
                                          jfs.window_dense(0, jfs.n_held))
            assert tfs.factor_bytes() == jfs.factor_bytes()
            assert tpf.range_colsums(tfs, held) == jpf.range_colsums(jfs,
                                                                     held)


def test_partition_service_ops_equal_the_jax_service(graphs):
    """One partition worker in each package: part_info, the colsum
    exchange, tile_pull, partial_topk / partial_scores, a staged and
    sealed routed delta, then the partial ops again — every answer equal;
    before the exchange a partial op is transient; a tile pull off the
    owner redirects."""
    jmp, tmp = metapaths(graphs)
    js = jsp.PartitionService(graphs[0], jmp, 1, 3, 2)
    ts = tsp.PartitionService(graphs[1], tmp, 1, 3, 2,
                              config=tsp.PartitionConfig(device="cpu"))
    resp = handle_request(ts, {"id": 1, "op": "partial_topk", "range": 1,
                               "row": 1, "k": 3, "cols": [], "vals": [],
                               "d_source": 0.0})
    assert not resp["ok"] and resp.get("transient")
    assert ts.part_info({}) == js.part_info({})
    # the router's global colsum, from every range's contribution
    g = np.zeros(ts.fs.v)
    for part in range(3):
        svc = tsp.PartitionService(graphs[1], tmp, part, 3, 1,
                                   config=tsp.PartitionConfig(device="cpu"))
        for payload in tpf.range_colsums(svc.fs, svc.held).values():
            g[payload["cols"]] += payload["vals"]
    nz = np.flatnonzero(g)
    init = {"mode": "init", "cols": nz.tolist(), "vals": g[nz].tolist()}
    assert ts.set_colsum(init) == js.set_colsum(init)
    lo, _ = ts.pmap.range_of(1)
    assert ts.tile_pull({"row": 3}) == js.tile_pull({"row": 3})
    assert ts.tile_pull({"row": 3})["wrong_owner"]

    def partials():
        tile = ts.tile_pull({"row": lo + 2})
        assert tile == js.tile_pull({"row": lo + 2})
        for rng_idx in ts.held:
            req = {"range": rng_idx, "row": lo + 2, "k": 6, **tile}
            assert ts.partial_topk(req) == js.partial_topk(req)
            assert ts.partial_scores(req) == js.partial_scores(req)

    partials()
    blk = graphs[1].blocks["author_of"]
    upd = {"seq": 1, "attempt": 1,
           "add_edges": [{"rel": "author_of", "src_row": lo + 2,
                          "dst_row": 7}],
           "remove_edges": [{"rel": "author_of", "src_row": int(blk.rows[j]),
                             "dst_row": int(blk.cols[j])}
                            for j in np.flatnonzero(blk.rows == lo + 5)[:1]]}
    staged = ts.part_update(upd)
    assert staged == js.part_update(upd)
    dg = {}
    for payload in staged["contrib"].values():
        for col, val in zip(payload["cols"], payload["vals"]):
            dg[col] = dg.get(col, 0.0) + val
    seal = {"mode": "delta", "seq": 1, "attempt": 1, "cols": list(dg),
            "vals": list(dg.values())}
    assert ts.set_colsum(seal) == js.set_colsum(seal)
    partials()
    assert ts.partition_state() == js.partition_state()


def test_routed_answers_equal_the_jax_router_through_deltas():
    """Random fleets (2-5 partitions, one holding bitpacked slices) under
    random routed deltas: every topk AND scores answer of the port's
    router equals the JAX router's and the single-host oracle's, ties
    included (few venues: score plateaus)."""
    rng = np.random.default_rng(29)
    for p_count, fmt in ((2, None), (4, None), (5, None), (3, "bitpacked")):
        jhin = jsyn.synthetic_hin(50 + int(rng.integers(0, 40)), 90, 3,
                                  seed=int(rng.integers(0, 1000)))
        graphs = (jhin, port_hin(jhin))
        oracle = _oracle(graphs[1], metapaths(graphs)[1])
        fleets = _Fleets(graphs, p_count, factor_format=fmt)
        try:
            for _round in range(3):
                for row in rng.integers(0, oracle.n, size=5):
                    jr, tr = fleets.both({"id": 1, "op": "topk",
                                          "row": int(row), "k": 8})
                    assert _topk(tr) == _topk(jr) == _oracle_topk(
                        oracle, row, 8)
                row = int(rng.integers(0, oracle.n))
                jr, tr = fleets.both({"id": 2, "op": "scores", "row": row})
                assert tr["result"] == jr["result"]
                assert tr["result"]["scores"] == oracle.scores_index(
                    row).tolist()
                cur = oracle.hin.blocks["author_of"]
                j = int(rng.integers(0, cur.rows.shape[0]))
                existing = set(zip(cur.rows.tolist(), cur.cols.tolist()))
                add = (int(cur.rows[j]), int(cur.cols[j]))
                while add in existing:  # a new edge, as the wire requires
                    add = (int(rng.integers(0, oracle.n)),
                           int(rng.integers(0, 90)))
                upd = {"add_edges": [{"rel": "author_of", "src_row": add[0],
                                      "dst_row": add[1]}],
                       "remove_edges": [{"rel": "author_of",
                                         "src_row": int(cur.rows[j]),
                                         "dst_row": int(cur.cols[j])}]}
                jr, tr = fleets.both({"id": 3, "op": "update", **upd})
                assert tr["ok"] and jr["ok"]
                assert {k: tr["result"][k] for k in ("seq", "sealed",
                                                     "re_encoded_rows")} == {
                    k: jr["result"][k] for k in ("seq", "sealed",
                                                 "re_encoded_rows")}
                oracle.update(tdl.delta_from_records(oracle.hin, **upd))
        finally:
            fleets.close()
            oracle.close()


@pytest.mark.chaos
def test_worker_killed_mid_batch_loses_nothing(graphs):
    """Replication 2: a worker SIGKILLed with 40 queries in flight; every
    answer arrives, equal to the JAX router's (no kill there)."""
    fleets = _Fleets(graphs, 3)
    try:
        port = fleets.routers[1]
        futs = [port.submit({"id": i, "op": "topk", "row": i % 140, "k": 5})
                for i in range(40)]
        fleets.transports[1]["w1"].kill()
        resps = [f.result(timeout=30) for f in futs]
        for i, resp in enumerate(resps):
            want = fleets.routers[0].request(
                {"id": i, "op": "topk", "row": i % 140, "k": 5}, timeout=30)
            assert _topk(resp) == _topk(want)
        assert port.stats()["router"]["workers"]["w1"]["status"] == "down"
        # an update with the dead holder seals on the survivors
        upd = {"id": 9, "op": "update", "add_edges": [
            {"rel": "author_of", "src_row": 100, "dst_row": 3}]}
        resp = port.request(upd, timeout=30)
        assert resp["ok"] and "w1" not in resp["result"]["sealed"]
        fleets.routers[0].request(upd, timeout=30)
        for row in (100, 0, 139):
            jr, tr = fleets.both({"id": 2, "op": "topk", "row": row, "k": 5})
            assert _topk(tr) == _topk(jr)
    finally:
        fleets.close()


@pytest.mark.chaos
def test_missed_broadcast_is_fenced_then_replayed(graphs):
    """The first part_update send is dropped: w0 lags, is fenced (answers
    stay exact through the mirrors) and is caught up by ordered replay;
    node appends are refused, as in the JAX router."""
    jmp, tmp = metapaths(graphs)
    oracle = _oracle(graphs[1], tmp)
    tinject.install_plan("delta_broadcast:error:1")
    jinject.reset()
    fleet = None
    try:
        fleet = _Fleets(graphs, 3)
        router = fleet.routers[1]
        adds = [{"rel": "author_of", "src_row": 5, "dst_row": 11}]
        resp = router.request({"id": 1, "op": "update", "add_edges": adds},
                              timeout=30)
        assert resp["ok"] and resp["result"]["lagging"] == ["w0"]
        oracle.update(tdl.delta_from_records(oracle.hin, add_edges=adds))
        for row in (0, 5, 70, 139):
            r = router.request({"id": 2, "op": "topk", "row": row, "k": 5},
                               timeout=30)
            assert _topk(r) == _oracle_topk(oracle, row, 5)
        deadline = time.monotonic() + 10
        while router.stats()["router"]["workers"]["w0"]["lag"]:
            assert time.monotonic() < deadline, "w0 never caught up"
            time.sleep(0.02)
        for router_ in fleet.routers:
            resp = router_.request({"id": 3, "op": "update", "add_nodes": [
                {"type": "author", "id": "a_new"}]}, timeout=30)
            assert not resp["ok"] and "edge deltas only" in resp["error"]
    finally:
        tinject.reset()
        if fleet is not None:
            fleet.close()
        oracle.close()


def test_router_cli_partition_mode(tmp_path):
    """``dpathsim-torch router --mode partition --workers 3`` (port
    partition workers as subprocesses, --platform cpu): its topk, scores
    and update answers equal the JAX partition router's."""
    spec = "synthetic:authors=140,papers=230,venues=8,seed=11,ids=1"
    script = [
        {"id": 1, "op": "topk", "row": 3, "k": 5},
        {"id": 2, "op": "scores", "row": 4},
        {"id": 3, "op": "stats"},
        {"id": 9, "op": "shutdown"},
    ]
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "router",
         "--mode", "partition", "--workers", "3", "--replication", "2",
         "--dataset", spec, "--platform", "cpu", "--headroom", "0",
         "--k", "5"],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = [json.loads(line) for line in proc.stdout.splitlines()]
    by_row = {r["result"].get("row"): r for r in out
              if r.get("ok") and "row" in r.get("result", {})}
    stats = next(r for r in out if r.get("id") == 3)
    assert stats["result"]["router"]["mode"] == "partition"
    assert stats["result"]["router"]["partitions"] == 3
    jhin = jsyn.synthetic_hin(**SPEC, materialize_ids=True)
    fleets = _Fleets((jhin, port_hin(jhin)), 3)
    try:
        for req in script[:2]:
            jr, tr = fleets.both(req)
            assert by_row[req["row"]]["result"] == jr["result"] == \
                tr["result"]
    finally:
        fleets.close()
