"""The batch CLI's resilience seams in the port, on the CPU: the
platform's degradation chain (on the card it never steps down to the
host's numpy oracle — checked as data, no card needed), injected
``backend_init`` / ``tile_execute`` / ``checkpoint_write`` faults
(``PATHSIM_FAULT_PLAN``) retried or degraded with the same answer, and a
preempted ``torch-sparse --checkpoint-dir`` run that exits 75 and
resumes to a TSV byte-identical to an uninterrupted run's."""

import json

import pytest

from distributed_pathsim_tpu_torch import resilience
from distributed_pathsim_tpu_torch.backends import base as tbase
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.resilience import degrade, inject
from distributed_pathsim_tpu_torch.utils.device import DeviceUnavailable
from torch_port_util import backend_graphs, metapaths, write_cli_gexf


@pytest.fixture(autouse=True)
def clean_injector(monkeypatch):
    monkeypatch.setenv("PATHSIM_RETRY_BASE_DELAY", "0")
    monkeypatch.setenv("PATHSIM_MAX_RETRIES", "3")
    inject.reset()
    yield
    inject.reset()
    resilience.preemption_handler.reset()


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    return write_cli_gexf(tmp_path_factory.mktemp("res") / "g.gexf")


def test_chain_on_cpu_and_cuda_as_data():
    assert resilience.backend_chain("torch-sparse", "cpu") == [
        "torch-sparse", "torch", "numpy"]
    assert resilience.backend_chain("torch-sparse", "cuda") == [
        "torch-sparse", "torch"]
    assert resilience.backend_chain("torch", "cuda") == ["torch"]
    assert resilience.backend_chain("numpy", "cpu") == ["numpy"]
    for steps in degrade.BACKEND_DEGRADATION.values():
        assert "numpy" not in steps  # the oracle is every chain's floor
    assert "numpy" not in degrade.BACKEND_DEGRADATION["cuda"].values()
    # a serving engine's step-down is its chain's end: torch on the card
    # with the options it understands, the numpy oracle on the host with
    # the memo alone (as the JAX service), and none from a chain's end
    memo = object()
    opts = {"device": "cuda", "dtype": "float32", "tile_rows": 64,
            "subchain_memo": memo}
    assert resilience.engine_fallback("torch-sparse", opts, "cuda") == (
        "torch", {"device": "cuda", "dtype": "float32",
                  "subchain_memo": memo})
    assert resilience.engine_fallback(
        "torch-sparse", {**opts, "device": "cpu"}, "cpu") == (
        "numpy", {"subchain_memo": memo})
    assert resilience.engine_fallback("torch", opts, "cuda") is None
    assert resilience.engine_fallback("numpy", {}, "cpu") is None


@pytest.mark.parametrize("device,want", [
    ("cuda", ["torch-sparse", "torch"]),
    ("cpu", ["torch-sparse", "torch", "numpy"]),
])
def test_persistent_failure_walks_the_platform_chain(monkeypatch, device,
                                                     want):
    """Every backend keeps failing transiently: the chain is walked in
    order and the last error raises. With ``device="cuda"`` the walk
    stops at ``torch``: numpy is never built. (``create_backend`` is
    replaced, so no card is needed.)"""
    # counts every attempt: no ambient PATHSIM_FAULT_PLAN may add one
    inject.install_plan("")
    tried = []

    def failing(name, hin, metapath, **opts):
        tried.append((name, opts.get("device")))
        raise resilience.TransientError(f"{name} wedged")

    monkeypatch.setattr(tbase, "create_backend", failing)
    graphs = backend_graphs()
    _, tmp = metapaths(graphs)
    with pytest.raises(resilience.TransientError, match=f"{want[-1]} wedged"):
        resilience.create_backend_resilient(
            "torch-sparse", graphs[1], tmp, device=device,
            policy=resilience.RetryPolicy(max_attempts=2, base_delay=0.0),
        )
    assert [n for n, _ in tried] == [n for n in want for _ in range(2)]
    # numpy takes no device; the device backends keep theirs
    assert all((d is None) == (n == "numpy") for n, d in tried)
    # a card that is gone is not retried and not stepped down from
    tried.clear()

    def gone(name, hin, metapath, **opts):
        tried.append(name)
        raise DeviceUnavailable("no CUDA device is available")

    monkeypatch.setattr(tbase, "create_backend", gone)
    with pytest.raises(DeviceUnavailable):
        resilience.create_backend_resilient("torch-sparse", graphs[1], tmp,
                                            device=device)
    assert tried == ["torch-sparse"]


def _events(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _rank(gexf, tmp_path, name, extra=(), backend="torch-sparse"):
    tsv = tmp_path / f"{name}.tsv"
    metrics = tmp_path / f"{name}.jsonl"
    rc = torch_main(["--dataset", gexf, "--platform", "cpu", "--backend",
                     backend, "--top-k", "5", "--quiet", "--ranking-out",
                     str(tsv), "--metrics", str(metrics), *extra])
    return rc, tsv, metrics


@pytest.mark.chaos
def test_backend_init_fault_degrades_with_the_same_answer(
        gexf, tmp_path, monkeypatch, capsys):
    rc, want, _ = _rank(gexf, tmp_path, "clean")
    assert rc == 0
    monkeypatch.setenv(inject.ENV_VAR, "backend_init:error:3")
    inject.reset()
    rc, got, metrics = _rank(gexf, tmp_path, "degraded")
    assert rc == 0 and got.read_bytes() == want.read_bytes()
    events = _events(metrics)
    deg = [e for e in events if e.get("event") == "degrade"]
    assert [(e["from_"], e["to"], e["platform"]) for e in deg] == [
        ("torch-sparse", "torch", "cpu")]
    assert any(e.get("event") == "degraded_backend_active" for e in events)
    assert "[pathsim:degrade]" in capsys.readouterr().err
    # --no-degrade fails fast instead (an unexpected error: a traceback
    # and exit 1 from the interpreter, as in the JAX package)
    inject.reset()
    with pytest.raises(inject.InjectedFault):
        _rank(gexf, tmp_path, "nodegrade", ["--no-degrade"])


@pytest.mark.chaos
@pytest.mark.parametrize("plan,seam", [
    ("tile_execute:error:2", "tile_execute"),
    ("checkpoint_write:partial:1", "checkpoint_write"),
])
def test_tile_and_checkpoint_faults_are_retried(gexf, tmp_path, monkeypatch,
                                                plan, seam):
    rc, want, _ = _rank(gexf, tmp_path, "clean", ["--tile-rows", "64"])
    assert rc == 0
    monkeypatch.setenv(inject.ENV_VAR, plan)
    inject.reset()
    rc, got, metrics = _rank(gexf, tmp_path, "faulty", [
        "--tile-rows", "64", "--checkpoint-dir", str(tmp_path / "ck")])
    assert rc == 0 and got.read_bytes() == want.read_bytes()
    events = _events(metrics)
    retries = [e for e in events if e.get("event") == "retry"]
    assert retries and all(e["seam"] == seam for e in retries)
    assert len(retries) == int(plan.split(":")[2])
    assert not any(e.get("event") == "degrade" for e in events)


@pytest.mark.chaos
def test_preempted_sweep_exits_75_and_resumes_identically(
        gexf, tmp_path, monkeypatch, capsys):
    """A preemption request after the 3rd row tile: the finished tiles
    are flushed to the checkpoint, the CLI exits 75 with a resume hint,
    and the rerun skips them and writes a TSV byte-identical to an
    uninterrupted run's."""
    rc, want, _ = _rank(gexf, tmp_path, "clean", ["--tile-rows", "64"])
    assert rc == 0
    ckpt = tmp_path / "ck"
    args = ["--tile-rows", "64", "--checkpoint-dir", str(ckpt)]
    monkeypatch.setenv(inject.ENV_VAR, "tile_execute:preempt:1@2")
    inject.reset()
    capsys.readouterr()
    rc, _, metrics = _rank(gexf, tmp_path, "preempted", args)
    assert rc == resilience.PREEMPTED_EXIT_CODE == 75
    err = capsys.readouterr().err
    assert "preempted" in err and "--checkpoint-dir" in err
    manifest = json.loads((ckpt / "manifest.json").read_text())
    done = sorted(k for k in manifest if k.startswith("topk5_rowtile_"))
    assert done == ["topk5_rowtile_0", "topk5_rowtile_1", "topk5_rowtile_2"]
    assert any(e.get("event") == "preempted" for e in _events(metrics))
    monkeypatch.delenv(inject.ENV_VAR)
    inject.reset()
    resilience.preemption_handler.reset()
    injector = inject.install_plan("")
    rc, got, _ = _rank(gexf, tmp_path, "resumed", args)
    assert rc == 0 and got.read_bytes() == want.read_bytes()
    assert injector.hits["tile_execute"] == 6 - 3  # 350 rows / 64 = 6 tiles
