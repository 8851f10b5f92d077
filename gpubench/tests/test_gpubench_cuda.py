"""Each cell as committed, run once by ``run.py`` on the card with a
short window (``-m cuda``; skipped without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from gpubench.tests._tiny import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    r = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", "1", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["correct"] is True, r.stderr[-4000:]
    assert rec["device"]["platform"] == "gpu" and rec["metrics"]
    if trace:
        assert rec["device"]["busy_s"] > 0 and rec["breakdown"]["device_ops"]
