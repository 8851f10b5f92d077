"""The port's multi-process path (``parallel/multihost.py``) on the CPU:
the rendezvous is a no-op for one process, the flag rules are the JAX
CLI's, and a REAL two-process gloo job on loopback — the twin of
tests/test_multihost.py's two-process cluster — writes the golden log
of one process, with process 1 muted. Across processes the ring's hop,
the colsum psum and the final fetch go through ``torch.distributed``."""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.parallel import multihost
from distributed_pathsim_tpu_torch.parallel.mesh import make_mesh
from torch_port_util import write_cli_gexf

REPO = str(pathlib.Path(__file__).resolve().parents[1])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(code: str):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={k: v for k, v in os.environ.items()
             if k not in multihost._CLUSTER_ENV_VARS},
    )


def _wait(procs, timeout=240):
    outs = []
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_rendezvous_is_a_noop_for_one_process(monkeypatch):
    for var in multihost._CLUSTER_ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_multihost(platform="cpu") is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    mesh = multihost.make_hybrid_mesh(tp=2, platform="cpu", n_local=4)
    assert mesh.shape == {"dp": 2, "tp": 2} and not mesh.multiprocess
    with pytest.raises(ValueError, match="must divide"):
        multihost.make_hybrid_mesh(tp=3, platform="cpu", n_local=4)
    with pytest.raises(ValueError, match="--num-processes"):
        multihost.initialize_multihost("127.0.0.1:1", platform="cpu")


def test_host_row_range_and_first_block_cover_the_padding():
    mesh = make_mesh(3, platform="cpu")
    assert multihost.host_row_range(10, mesh) == (0, 12)
    rows = np.arange(20, dtype=np.float64).reshape(10, 2)
    asked = []

    def load(a, b):
        asked.append((a, b))
        return rows[a:b]

    parts = multihost.distributed_first_block(load, 10, 2, mesh)
    assert asked == [(0, 10)] and [p.shape for p in parts] == [(4, 2)] * 3
    assert torch.equal(torch.cat(parts)[:10], torch.as_tensor(rows).float())
    assert float(torch.cat(parts)[10:].abs().sum()) == 0.0


def test_cli_rendezvous_flag_rules(tmp_path, capsys):
    """The JAX CLI's rules: the process flags need the coordinator, the
    rendezvous needs the sharded backend, the ensemble refuses it — each
    before any rendezvous; a one-process rendezvous runs."""
    from distributed_pathsim_tpu.cli import main as jax_main

    gexf = write_cli_gexf(tmp_path / "g.gexf")
    port = _free_port()
    for extra, msg in (
        (["--process-id", "0"], "require --coordinator-address"),
        (["--coordinator-address", f"127.0.0.1:{port}"], "single-process"),
        (["--metapath", "APVPA,APA", "--coordinator-address",
          f"127.0.0.1:{port}"], "multi-metapath mode does not support"),
    ):
        argv = ["--dataset", gexf, "--top-k", "3", "--quiet", *extra]
        assert torch_main(argv + ["--platform", "cpu"]) == 1
        err_t = capsys.readouterr().err
        assert jax_main(argv + ["--platform", "cpu"]) == 1
        err_j = capsys.readouterr().err
        assert msg in err_t and msg in err_j, (err_t, err_j)
    out = tmp_path / "one.tsv"
    assert torch_main(["--dataset", gexf, "--platform", "cpu", "--quiet",
                       "--backend", "torch-sharded", "--coordinator-address",
                       f"127.0.0.1:{port}", "--num-processes", "1",
                       "--process-id", "0", "--top-k", "5",
                       "--ranking-out", str(out)]) == 0
    assert out.exists() and not torch.distributed.is_initialized()


def test_two_process_gloo_cluster_golden(tmp_path):
    """Both processes run the same CLI command on loopback (gloo): each
    densifies its own rows, the ring crosses the process boundary every
    step, and process 0 writes the log and ranking of a one-process
    --backend torch run; process 1 writes nothing."""
    gexf = write_cli_gexf(tmp_path / "g.gexf")
    base = ["--dataset", gexf, "--platform", "cpu", "--quiet"]
    one_log, one_tsv = tmp_path / "one.log", tmp_path / "one.tsv"
    assert torch_main(base + ["--source", "author_5", "--top-k", "6",
                              "--output", str(one_log)]) == 0
    assert torch_main(base + ["--top-k", "7", "--ranking-out",
                              str(one_tsv)]) == 0
    ports = (_free_port(), _free_port())

    def child(pid):
        return _spawn(f"""
            from distributed_pathsim_tpu_torch.cli import main
            common = {base!r} + ["--backend", "torch-sharded",
                                 "--num-processes", "2", "--process-id",
                                 "{pid}"]
            assert main(common + ["--coordinator-address",
                                  "127.0.0.1:{ports[0]}", "--source",
                                  "author_5", "--top-k", "6", "--output",
                                  {str(tmp_path / f"mh{pid}.log")!r}]) == 0
            assert main(common + ["--coordinator-address",
                                  "127.0.0.1:{ports[1]}", "--top-k", "7",
                                  "--ranking-out",
                                  {str(tmp_path / f"mh{pid}.tsv")!r}]) == 0
            print("MH2_OK")
            """)

    outs = _wait([child(0), child(1)])
    for pid, (stdout, stderr) in enumerate(outs):
        assert "MH2_OK" in stdout, f"proc{pid}: {stderr[-2000:]}"

    def grammar(path):
        return [ln for ln in path.read_text().splitlines()
                if not ln.startswith("***")]

    assert grammar(tmp_path / "mh0.log") == grammar(one_log)
    assert (tmp_path / "mh0.tsv").read_bytes() == one_tsv.read_bytes()
    assert not (tmp_path / "mh1.log").exists()
    assert not (tmp_path / "mh1.tsv").exists()


def test_two_processes_two_shards_each(tmp_path):
    """Library level: two gloo processes of two shards each (a 4-shard
    ring whose hop crosses processes at shards 1 → 2 and 3 → 0): the
    chain outputs (both strategies), the ring (K3's plain version and the
    fold) and the stepwise ring with its checkpoint equal one process's
    4-shard run."""
    rng = np.random.default_rng(7)
    c = rng.integers(0, 3, size=(37, 11)).astype(np.float32)
    np.save(tmp_path / "c.npy", c)
    port = _free_port()

    def child(pid):
        return _spawn(f"""
            import numpy as np, torch
            from distributed_pathsim_tpu_torch.parallel import multihost
            from distributed_pathsim_tpu_torch.parallel import sharded as sh
            from distributed_pathsim_tpu_torch.parallel.mesh import (
                gather_rows, make_mesh)
            from distributed_pathsim_tpu_torch.utils.checkpoint import (
                CheckpointManager)
            c = np.load({str(tmp_path / "c.npy")!r})
            assert multihost.initialize_multihost(
                "127.0.0.1:{port}", 2, {pid}, platform="cpu")
            mesh = multihost.make_hybrid_mesh(platform="cpu", n_local=2)
            assert mesh.size == 4 and mesh.first_shard == 2 * {pid}
            first = multihost.distributed_first_block(
                lambda a, b: c[a:b], 37, 11, mesh)
            local = make_mesh(4, platform="cpu")
            lfirst = sh.shard_first_block_rows(c, local)
            for strategy in ("allgather", "ring"):
                m, r = sh.sharded_chain_outputs(first, (), mesh=mesh,
                                                allpairs_strategy=strategy)
                lm, lr = sh.sharded_chain_outputs(lfirst, (), mesh=local,
                                                  allpairs_strategy=strategy)
                assert np.array_equal(gather_rows(m, mesh),
                                      gather_rows(lm, local))
                assert np.array_equal(gather_rows(r, mesh),
                                      gather_rows(lr, local))
            for kernel in (True, False):
                for variant in ("rowsum", "diagonal"):
                    got = sh.sharded_topk(first, (), mesh=mesh, k=5,
                                          n_true=37, variant=variant,
                                          use_kernel=kernel)
                    want = sh.sharded_topk(lfirst, (), mesh=local, k=5,
                                           n_true=37, variant=variant,
                                           use_kernel=kernel)
                    for g, w in zip(got, want):
                        assert np.array_equal(gather_rows(g, mesh),
                                              gather_rows(w, local))
            ck = CheckpointManager({str(tmp_path)!r} + "/ck{pid}",
                                   config={{"run": 1}})
            got = sh.sharded_topk_stepwise(first, (), mesh=mesh, k=5,
                                           n_true=37, use_kernel=True,
                                           ckpt=ck)
            want = sh.sharded_topk(lfirst, (), mesh=local, k=5, n_true=37)
            for g, w in zip(got, want):
                assert np.array_equal(gather_rows(g, mesh),
                                      gather_rows(w, local))
            assert ck.done_keys() == ["ring_bests_after_3"], ck.done_keys()
            multihost.shutdown_multihost()
            print("MH4_OK")
            """)

    outs = _wait([child(0), child(1)])
    for pid, (stdout, stderr) in enumerate(outs):
        assert "MH4_OK" in stdout, f"proc{pid}: {stderr[-2000:]}"
