"""Port twin of tests/test_fleet_obs.py::test_bench_fleet_obs_smoke, on
the CPU: the port harness's fleet-obs regime
(``distributed_pathsim_tpu_torch.bench_serving.run_fleet_obs_smoke``), a
real port Router over two ``dpathsim-torch worker`` subprocesses
(``--backend torch --platform cpu``, spawned from the router CLI's own
argv builder) under closed-loop load with one SIGKILL mid-load.

The stitched cross-process trace has zero broken parent links; the
merged request count equals the sum of the workers' counts, both
workers contributing; the latency SLO burns under an injected latency
fault (a 100 µs p99 objective no subprocess round trip meets) while
availability stays quiet; the flight recorder holds the failover; no
request is lost and the survivor adds no compile; the per-worker
artifacts are forwarded; ``dpathsim-torch fleet-stats`` renders the
router's fleet snapshot.
"""

import json
import os
import shutil
import subprocess
import sys

from distributed_pathsim_tpu_torch import bench_serving as bs
from distributed_pathsim_tpu_torch.router.cli import _worker_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fleet_obs_smoke(monkeypatch, tmp_path):
    argv = _worker_argv(bs._fleet_obs_router_args(str(tmp_path), "torch",
                                                  "cpu"), 0)
    assert argv[1:4] == ["-m", "distributed_pathsim_tpu_torch.cli", "worker"]
    compiles = []
    real = bs._router_worker_compiles

    def watched(router):
        compiles.append(real(router))
        return compiles[-1]

    monkeypatch.setattr(bs, "_router_worker_compiles", watched)
    result = bs.run_fleet_obs_smoke(platform="cpu")
    tmp = result["tmpdir"]
    try:
        checks = result["smoke_checks"]
        assert all(checks.values()), checks
        audit = result["trace_audit"]
        worker_counts = result["per_worker_request_counts"]
        merged_count = result["merged_request_count"]
        assert result["load"]["lost"] == 0, result["load"]["errors"]
        assert audit["stitched_cross_process"] >= 1
        assert audit["broken_parent_links"] == 0
        assert merged_count == sum(worker_counts.values()) > 0
        assert sum(1 for wid, n in worker_counts.items()
                   if wid != "router" and n > 0) == 2
        assert result["slo"]["latency_p99"]["alerts"] >= 1
        assert result["slo"]["availability"]["alerts"] == 0
        with open(os.path.join(tmp, "flight.json"), encoding="utf-8") as f:
            reasons = [r["reasons"] for r in json.load(f)["records"]]
        assert any("failover" in r for r in reasons)
        dump = result["flight_dump"]
        assert dump["records"] > 0 and dump["spans"] > 0
        h0, survivors = compiles  # after the warm load, after the kill
        assert survivors == {"w1": h0["w1"]}
        assert result["steady_state_compiles"] == 0
        # the drained survivor left its own artifacts (w0 was SIGKILLed)
        assert os.path.exists(os.path.join(tmp, "trace.w1.json"))
        assert os.path.exists(os.path.join(tmp, "fleet.w1.prom"))
        with open(os.path.join(tmp, "fleet.prom"), encoding="utf-8") as f:
            assert 'worker="w1"' in f.read()
        out = subprocess.run(
            [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
             "fleet-stats", os.path.join(tmp, "fleet.json")],
            capture_output=True, text=True, timeout=120, cwd=REPO,
        )
        assert out.returncode == 0, out.stderr
        assert out.stdout.startswith("fleet: 2 workers (1 up)"), out.stdout
        assert "latency_p99" in out.stdout
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
