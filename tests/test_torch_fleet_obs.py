"""Port twin of tests/test_fleet_obs.py::test_bench_fleet_obs_smoke, on
the CPU: a real port Router over two ``dpathsim-torch worker``
subprocesses (``--platform cpu``, spawned from the router CLI's own
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
import subprocess
import sys
import threading
import time

import numpy as np

from distributed_pathsim_tpu_torch import obs
from distributed_pathsim_tpu_torch.obs import fleet as obs_fleet
from distributed_pathsim_tpu_torch.obs.slo import SLOSpec
from distributed_pathsim_tpu_torch.router import (
    Router,
    RouterConfig,
    SubprocessTransport,
)
from distributed_pathsim_tpu_torch.router.cli import (
    _worker_argv,
    parse_router_args,
)
from distributed_pathsim_tpu_torch.router.loadgen import run_router_clients

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "synthetic:authors=256,papers=448,venues=10,seed=0"
FAM = "dpathsim_serve_request_seconds"


def _count(snap, fam=FAM):
    return sum(c["count"] for c in (snap.get(fam) or {"values": []})["values"])


def _compiles(router):
    return {wid: int(router.worker_health(wid).get("compiles", 0))
            for wid, w in router.workers.items() if w.status == "up"}


def test_fleet_obs_smoke(tmp_path):
    args = parse_router_args([
        "--dataset", SPEC, "--backend", "torch", "--platform", "cpu",
        "--max-batch", "8", "--max-wait-ms", "1.0", "--k", "5",
        "--metrics-file", str(tmp_path / "fleet.prom"),
        "--trace-out", str(tmp_path / "trace.json"),
        "--metrics-interval", "1.0",
    ])
    windows = ((1.0, 1.0), (3.0, 1.0))
    specs = (
        SLOSpec(name="availability", kind="availability",
                metric="dpathsim_router_requests_total",
                objective=0.999, good_labels=(("outcome", "ok"),),
                windows=windows),
        SLOSpec(name="latency_p99", kind="latency",
                metric="dpathsim_router_request_seconds",
                objective=0.99, threshold=1e-4, windows=windows),
    )
    transports = {f"w{i}": SubprocessTransport(f"w{i}", _worker_argv(args, i))
                  for i in range(2)}
    assert transports["w0"].argv[1:4] == [
        "-m", "distributed_pathsim_tpu_torch.cli", "worker"]
    obs.configure(metrics=True, tracing=True, trace_sample=1)
    obs.get_tracer().clear()
    router = Router(transports, RouterConfig(
        heartbeat_interval_s=0.2, heartbeat_miss_limit=15, hedge_ms=300.0,
        max_inflight=4096, scrape_interval_s=0.4, slo_specs=specs,
        slow_ms=1e9, flight_capacity=256))
    uniform = np.random.default_rng(0).integers(0, 256, size=(6, 16))
    try:
        router.start(ready_timeout=120)
        run_router_clients(router, uniform[:4, :8].tolist(), 5)  # warm
        router.fleet_metrics(refresh=True)  # both workers scraped once
        h0 = _compiles(router)
        started = threading.Event()

        def killer():
            started.wait()
            time.sleep(0.05)
            transports["w0"].kill()

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        started.set()
        res = run_router_clients(router, np.tile(uniform, (1, 6)).tolist(), 5)
        kt.join(timeout=30)
        time.sleep(1.0)  # two scrape windows over the load just seen
        router._evaluate_slo(time.monotonic())
        survivors = _compiles(router)
        fm = router.fleet_metrics(refresh=True)
        parts = router.metric_parts()
        worker_counts = {wid: _count(snap) for wid, snap in parts.items()}
        merged_count = _count(fm["merged"])
        audit = obs_fleet.audit_fleet_traces(router.collect_trace_parts())
        reasons = [r["reasons"] for r in router.flight.records()]
        dump = router.flight_dump(str(tmp_path / "flight.json"))
        obs_fleet.write_fleet_textfile(str(tmp_path / "fleet.prom"), parts)
        snapshot = tmp_path / "fleet.json"
        snapshot.write_text(json.dumps(fm))
    finally:
        router.close()
        obs.configure(metrics=True, tracing=False, trace_sample=1)
        obs.get_tracer().clear()
    assert res["lost"] == 0, res["errors"]
    assert audit["stitched_cross_process"] >= 1
    assert audit["broken_parent_links"] == 0
    assert merged_count == sum(worker_counts.values()) > 0
    assert sum(1 for wid, n in worker_counts.items()
               if wid != "router" and n > 0) == 2
    assert fm["slo"]["latency_p99"]["alerts"] >= 1
    assert fm["slo"]["availability"]["alerts"] == 0
    assert any("failover" in r for r in reasons)
    assert dump["records"] > 0 and dump["spans"] > 0
    assert survivors == {"w1": h0["w1"]}
    # the drained survivor left its own artifacts (w0 was SIGKILLed)
    assert (tmp_path / "trace.w1.json").exists()
    assert (tmp_path / "fleet.w1.prom").exists()
    assert 'worker="w1"' in (tmp_path / "fleet.prom").read_text()
    out = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.cli",
         "fleet-stats", str(snapshot)],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("fleet: 2 workers (1 up)"), out.stdout
    assert "latency_p99" in out.stdout
