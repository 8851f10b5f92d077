"""A run's entry and its last line, on the CPU with the port's plain
versions (``run_cell`` skips ``run.py``'s look for a card)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from gpubench import harness
from gpubench.tests._tiny import REPO, make_root

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CELL = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0][
    "name"]


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         CELL, "--seed", str(2**31 + 11), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_run_py_without_a_card_exits_nonzero_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = _run_py(REPO, env)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_run_py_with_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run_py(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.parametrize("cell,trace", [
    ("tinydense.rank-all.k10", False), ("tinydense.rank-all.k20", True),
    ("tinysparse.rank-all.k10", False), ("tinysparse.rank-all.k20", True)])
def test_cell_added_by_files_alone_runs_and_prints_the_keys(tmp_path, cell,
                                                            trace):
    root = make_root(tmp_path, mixes=("rank-all.k10", "rank-all.k20"))
    rec = harness.run_cell(root, cell, 2**31 + 3, 0.3, trace, "cpu")
    assert list(rec)[:5] == KEYS and list(rec)[-1] == "checks"
    assert rec["correct"] is True and rec["failed"] == 0
    assert rec["attempted"] >= 1
    bench = harness.Bench(root)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench.spec[kind]}
    # on the CPU the trace holds no device operation: the device readers
    # read nothing and their metrics are left out
    assert set(rec["metrics"]) == (
        {"backend_init_s"} if trace else want)
    assert all(set(m) == {"value", "unit"} for m in rec["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        rec["device"])
    assert set(rec["checks"]) == {"rank_gap"}
    json.dumps(rec)
