"""Port parity: the ``batch_blocks`` op and the campaign fleet
(``router/batch.py``), on the CPU.

- ``PathSimService.batch_blocks`` through ``handle_request``: topk and
  simjoin blocks equal to the JAX service's and to the single-host
  campaign; the ``(base_fp, delta_seq)`` and metapath fences refuse a
  stale campaign; a service without the op answers "requires a replica
  service";
- ``BlockScheduler`` over in-process port workers: fleet topk and
  simjoin bit-identical to single-host; a worker killed mid-campaign
  loses no block; a fleet with no matching token refuses;
- ``dpathsim-torch batch --workers 2 --platform cpu`` (subprocess
  workers) writes the single-host bytes."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.serving.protocol import (
    handle_request as jhandle,
)
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.batch import (
    BatchEngine,
    run_simjoin_campaign,
    run_topk_campaign,
)
from distributed_pathsim_tpu_torch.router import (
    InprocTransport,
    WorkerRuntime,
)
from distributed_pathsim_tpu_torch.router.batch import (
    BatchFleetError,
    BlockScheduler,
)
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request
from torch_port_util import metapaths, port_hin


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn.synthetic_hin(130, 240, 8, seed=5)
    return jhin, port_hin(jhin)


@pytest.fixture(scope="module")
def engine(graphs):
    return BatchEngine(graphs[1], metapaths(graphs)[1], block_rows=32,
                       device="cpu")


def _replica(hin, name="torch"):
    mp = metapaths((hin, hin))[1]
    return PathSimService(
        create_backend(name, hin, mp, device="cpu"),
        config=ServeConfig(warm=False, max_wait_ms=0.5))


def test_batch_blocks_equal_jax_and_fences(graphs, engine):
    jhin, thin = graphs
    js = JService(jcreate("jax", jhin, metapaths(graphs)[0]),
                  config=JConfig(warm=False, max_wait_ms=0.5))
    ts = _replica(thin)
    try:
        fp, seq = ts.consistency_token
        assert (fp, seq) == js.consistency_token
        ref = run_topk_campaign(engine, 7)
        for req in (
            {"id": 1, "op": "batch_blocks", "lo": 0, "hi": 32, "mode": "topk",
             "k": 7, "variant": "rowsum", "metapath": "APVPA",
             "base_fp": fp, "delta_seq": seq},
            {"id": 2, "op": "batch_blocks", "lo": 32, "hi": 64,
             "mode": "simjoin", "tau": 0.05, "base_fp": fp},
            {"id": 3, "op": "batch_blocks"},  # an empty block
            {"id": 4, "op": "batch_blocks", "lo": 0, "hi": 8,
             "base_fp": "sha256:not-this-graph", "delta_seq": 0},
            {"id": 5, "op": "batch_blocks", "lo": 0, "hi": 8,
             "metapath": "APA"},
            {"id": 6, "op": "batch_blocks", "lo": 0, "hi": 8,
             "mode": "pairs"},
        ):
            got, want = handle_request(ts, req), jhandle(js, req)
            assert (got["ok"], got.get("error")) == \
                (want["ok"], want.get("error")), req
            if got["ok"]:
                assert got["result"] == want["result"], req
        got = handle_request(ts, {"id": 1, "op": "batch_blocks", "lo": 0,
                                  "hi": 32, "k": 7})["result"]
        np.testing.assert_array_equal(np.asarray(got["vals"]), ref.vals[:32])
        np.testing.assert_array_equal(np.asarray(got["idxs"]), ref.idxs[:32])
        stale = handle_request(ts, {"id": 4, "op": "batch_blocks", "lo": 0,
                                    "hi": 8, "base_fp": "x"})
        assert not stale["ok"] and "stale batch campaign" in stale["error"]
    finally:
        js.close()
        ts.close()


def test_batch_blocks_requires_a_replica(graphs):
    """A service without the op (the JAX package's partition workers
    serve only the partial ops) answers the JAX package's error."""
    svc = _replica(graphs[1])
    try:
        class Partial:
            def __getattr__(self, name):
                if name == "batch_blocks":
                    raise AttributeError(name)
                return getattr(svc, name)

        resp = handle_request(Partial(), {"id": 1, "op": "batch_blocks"})
        assert not resp["ok"] and "replica service" in resp["error"]
    finally:
        svc.close()


class _BatchFleet:
    def __init__(self, hin, workers: int = 2, **sched_cfg):
        self.services = [_replica(hin) for _ in range(workers)]
        self.transports = {
            f"w{i}": InprocTransport(f"w{i}",
                                     WorkerRuntime(svc, worker_id=f"w{i}"))
            for i, svc in enumerate(self.services)
        }
        sched_cfg.setdefault("straggler_after_s", 5.0)
        self.sched = BlockScheduler(self.transports, **sched_cfg)
        self.sched.start()

    def close(self):
        self.sched.close()
        for svc in self.services:
            svc.close()


def test_fleet_topk_and_simjoin_bit_identical(graphs, engine):
    fleet = _BatchFleet(graphs[1], workers=2)
    try:
        ref = run_topk_campaign(engine, 7)
        res = run_topk_campaign(engine, 7, scheduler=fleet.sched)
        assert res.backend_mode == "fleet"
        np.testing.assert_array_equal(res.vals, ref.vals)
        np.testing.assert_array_equal(res.idxs, ref.idxs)
        ref = run_simjoin_campaign(engine, 0.05, grouping="degree")
        res = run_simjoin_campaign(engine, 0.05, grouping="natural",
                                   scheduler=fleet.sched)
        assert sorted(zip(res.rows, res.cols, res.scores)) == sorted(
            zip(ref.rows, ref.cols, ref.scores))
        with pytest.raises(ValueError, match="natural"):
            run_simjoin_campaign(engine, 0.05, grouping="degree",
                                 scheduler=fleet.sched)
    finally:
        fleet.close()


def test_fleet_worker_death_requeues_blocks(graphs):
    eng = BatchEngine(graphs[1], metapaths(graphs)[1], block_rows=16,
                      device="cpu")
    ref = run_topk_campaign(eng, 5)
    fleet = _BatchFleet(graphs[1], workers=2)
    killed = {"done": False}

    def on_block(done, total):
        if not killed["done"]:
            killed["done"] = True
            fleet.transports["w1"].kill()

    try:
        res = run_topk_campaign(eng, 5, scheduler=fleet.sched,
                                on_block=on_block)
        np.testing.assert_array_equal(res.vals, ref.vals)
        np.testing.assert_array_equal(res.idxs, ref.idxs)
    finally:
        fleet.close()


def test_fleet_with_no_matching_token_refuses(graphs):
    jhin2 = jsyn.synthetic_hin(130, 240, 8, seed=99)
    thin2 = port_hin(jhin2)
    eng2 = BatchEngine(thin2, metapaths((jhin2, thin2))[1], block_rows=32,
                       device="cpu")
    fleet = _BatchFleet(graphs[1], workers=1)
    try:
        with pytest.raises(BatchFleetError, match="no eligible"):
            run_topk_campaign(eng2, 5, scheduler=fleet.sched)
    finally:
        fleet.close()


def test_batch_cli_workers_write_single_host_bytes(tmp_path, capsys):
    """Two ``dpathsim-torch worker --platform cpu`` subprocesses behind
    the CLI's scheduler: the --out and --emit-pairs bytes of the
    single-host run, summary backend ``fleet``."""
    import json

    from distributed_pathsim_tpu_torch.cli import main as tmain

    spec = "synthetic:authors=80,papers=120,venues=5,seed=2"
    outs = {}
    for name, extra in (("one", []), ("two", ["--workers", "2"])):
        capsys.readouterr()
        assert tmain(["batch", "topk-all", "--dataset", spec, "--platform",
                      "cpu", "--block-rows", "16", "--k", "4", "--out",
                      str(tmp_path / f"{name}.npz"), "--emit-pairs",
                      str(tmp_path / f"{name}.jsonl"), *extra]) == 0
        outs[name] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert outs["two"]["backend"] == "fleet"
    for ext in ("npz", "jsonl"):
        assert (tmp_path / f"one.{ext}").read_bytes() == \
            (tmp_path / f"two.{ext}").read_bytes()


def test_candidate_scoring_equals_jax():
    """``score_candidates`` (the simjoin's exact pair blocks) and
    ``topk_from_candidate_scores`` against the JAX package's, on padded
    and duplicated candidate lists, boundary ties included."""
    from distributed_pathsim_tpu.ops import pathsim as jps
    from distributed_pathsim_tpu_torch.ops import pathsim as tps

    rng = np.random.default_rng(8)
    m = rng.integers(0, 5, (6, 40)).astype(np.float64)
    d_src = rng.integers(0, 30, 6).astype(np.float64)
    d_cand = rng.integers(0, 30, (6, 40)).astype(np.float64)
    s_t = tps.score_candidates(m, d_src, d_cand)
    np.testing.assert_array_equal(s_t, jps.score_candidates(m, d_src, d_cand))
    cols = rng.integers(-1, 25, (6, 40))  # -1 pads, repeats duplicate
    s_t = np.where(cols >= 0, s_t, -np.inf)
    for k in (1, 5, 30):
        for a, b in zip(tps.topk_from_candidate_scores(s_t, cols, k),
                        jps.topk_from_candidate_scores(s_t, cols, k)):
            np.testing.assert_array_equal(a, b)
