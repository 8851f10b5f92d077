"""The port's horizontal-tier entry points as processes, on the CPU.

- A standalone ``dpathsim-torch worker``: its first stdout line is the
  ``ready`` event; SIGTERM drains it (every accepted request answered, a
  ``drained`` event last) and it exits 0.
- Without a card and without ``--platform cpu``, ``worker`` and
  ``router`` exit 1 with "no CUDA device"; the lanes that come later
  (the serve flags ``serve`` refuses) exit 1 "not ported yet"; the
  partition flags refuse what the JAX package's refuse;
  ``--factor-format`` without torch-sparse is refused.
- ``dpathsim-torch router --workers 2 --platform cpu`` answers a JSONL
  script of topk, scores, update, health and drain, and its topk,
  scores and update answers equal the JAX package's ``dpathsim router``
  on the same synthetic graph.
- ``serve --metrics-file`` leaves a Prometheus textfile.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from distributed_pathsim_tpu_torch.cli import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "synthetic:authors=64,papers=96,venues=4,seed=1"


def test_standalone_worker_ready_and_sigterm_drain():
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "worker",
         "--dataset", SPEC, "--backend", "torch", "--platform", "cpu",
         "--no-warm", "--worker-id", "wS"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True, cwd=REPO,
    )
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["event"] == "ready" and ready["worker_id"] == "wS"
        assert ready["n"] == 64 and ready["backend"] == "torch"
        assert ready["delta_seq"] == 0 and ready["metapath"] == "APVPA"
        for i in range(3):
            proc.stdin.write(json.dumps(
                {"id": i, "op": "topk", "row": i, "k": 3}) + "\n")
        proc.stdin.write(json.dumps({"id": 3, "op": "health"}) + "\n")
        proc.stdin.flush()
        got = [json.loads(proc.stdout.readline()) for _ in range(4)]
        assert all(r["ok"] for r in got)
        assert sorted(r["id"] for r in got) == [0, 1, 2, 3]
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.2)  # let the signal latch before the next event
        proc.stdin.write(json.dumps({"id": 9, "op": "topk", "row": 1}) + "\n")
        proc.stdin.flush()
        tail = [json.loads(line) for line in proc.stdout]
        assert proc.wait(timeout=60) == 0
        # the post-signal line was never accepted; drained is the last word
        assert not any(r.get("id") == 9 for r in tail)
        assert tail[-1]["event"] == "drained" and tail[-1]["clean"]
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


def test_refusals_without_a_card_and_for_unported_modes(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    for cmd in ("worker", "router"):
        assert torch_main([cmd, "--dataset", SPEC]) == 1
        err = capsys.readouterr().err
        assert "no CUDA device" in err and "--platform cpu" in err, cmd
    # training towers in the service is ported: learned mode without a
    # checkpoint and the training flags parse for worker and router (the
    # router forwards them), as the JAX package's commands do
    from distributed_pathsim_tpu_torch.router.cli import (
        _worker_argv,
        parse_router_args,
        parse_worker_args,
    )

    for argv in (
        ["worker", "--topk-mode", "learned"],
        ["router", "--topk-mode", "learned"],
        ["worker", "--learned-dim", "16"],
        ["router", "--topk-mode", "learned", "--learned-checkpoint",
         "t.npz", "--learned-steps", "5"],
    ):
        parse = parse_router_args if argv[0] == "router" else \
            parse_worker_args
        args = parse([*argv[1:], "--dataset", SPEC, "--platform", "cpu"])
        for flag, val in zip(argv[1::2], argv[2::2]):
            assert str(getattr(args, flag[2:].replace("-", "_"))) == val, argv
        if argv[0] == "router":
            fwd = _worker_argv(args, 0)
            for flag, val in zip(argv[1::2], argv[2::2]):
                assert fwd[fwd.index(flag) + 1] == val, argv
    args = parse_worker_args(["--dataset", SPEC, "--topk-mode", "learned",
                              "--learned-checkpoint", "t.npz",
                              "--learned-cand-mult", "8"])
    assert (args.topk_mode, args.learned_checkpoint,
            args.learned_cand_mult) == ("learned", "t.npz", 8)
    # partition mode is ported: its flags parse, and what they refuse is
    # what the JAX package's worker refuses
    for argv, msg in (
        (["worker", "--partition-index", "0"],
         "--partition-index requires --partitions >= 1"),
        (["worker", "--partition-index", "2", "--partitions", "2"],
         "--partition-index 2 out of range [0, 2)"),
        (["router", "--mode", "partition", "--replication", "2",
          "--autoscale"], "--autoscale scales replicas"),
    ):
        assert torch_main([*argv, "--dataset", SPEC,
                           "--platform", "cpu"]) == 1, argv
        assert msg in capsys.readouterr().err, argv
    for cmd in ("worker", "router"):
        assert torch_main([cmd, "--factor-format", "bitpacked", "--dataset",
                           SPEC, "--platform", "cpu"]) == 1, cmd
        assert "requires --backend torch-sparse" in \
            capsys.readouterr().err, cmd


def _run_router(module, backend_flags, script):
    proc = subprocess.run(
        [sys.executable, "-m", module, "router", "--workers", "2",
         "--dataset", SPEC + ",ids=1", "--platform", "cpu", "--no-warm",
         "--k", "3", *backend_flags],
        input="\n".join(json.dumps(r) for r in script) + "\n",
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {r["id"]: r for r in map(json.loads, proc.stdout.splitlines())}


def test_router_cli_answers_match_jax_router_cli():
    script = [
        {"id": 1, "op": "topk", "row": 5},
        {"id": 2, "op": "topk", "source_id": "author_9", "k": 4},
        {"id": 3, "op": "scores", "row": 3},
        {"id": 4, "op": "update", "add_edges": [
            {"rel": "author_of", "src_row": 1, "dst_row": 7}]},
        {"id": 5, "op": "topk", "row": 1, "k": 5},
        {"id": 6, "op": "health"},
        {"id": 7, "op": "drain"},
    ]
    port = _run_router("distributed_pathsim_tpu_torch.cli",
                       ["--backend", "torch", "--no-compact"], script)
    jax = _run_router("distributed_pathsim_tpu.cli",
                      ["--backend", "jax", "--no-tuning", "--no-compact"],
                      script)
    assert sorted(port) == list(range(1, 8))
    assert all(r["ok"] for r in port.values()), port
    assert port[4]["result"]["applied"] == ["w0", "w1"]
    assert port[4]["result"]["mode"] == "delta"
    assert port[7]["result"] == {"shutdown": False, "draining": True,
                                 "clean": True}
    workers = port[6]["result"]["router"]["workers"]
    assert sorted(workers) == ["w0", "w1"]
    for rid in (1, 2, 3, 4, 5):
        assert port[rid]["result"] == jax[rid]["result"], rid


def test_serve_metrics_file_writes_a_prometheus_textfile(tmp_path):
    from torch_port_util import write_cli_gexf

    gexf = write_cli_gexf(tmp_path / "g.gexf")
    prom = tmp_path / "serve.prom"
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli", "serve",
         "--dataset", gexf, "--platform", "cpu", "--no-warm",
         "--metrics-file", str(prom), "--metrics-interval", "0.5"],
        input='{"id": 1, "op": "topk", "row": 2}\n{"id": 2, "op": "shutdown"}\n',
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    text = prom.read_text()
    assert "# TYPE dpathsim_request_seconds histogram" in text
    assert 'dpathsim_request_seconds_count{op="topk"} 1' in text


@pytest.mark.parametrize("flag", ["--metrics-file", "--metrics-interval"])
def test_serve_no_longer_refuses_the_exporter_flags(flag):
    from distributed_pathsim_tpu_torch.serving.cli import (
        NOT_PORTED_FLAGS,
        parse_serve_args,
    )

    assert flag not in NOT_PORTED_FLAGS
    args = parse_serve_args(["--dataset", "g.gexf", flag, "2"])
    assert getattr(args, flag[2:].replace("-", "_")) in ("2", 2.0)
