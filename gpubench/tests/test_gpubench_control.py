"""The control, the reference in TF32 put in the port's place, reads as
not correct against every configuration's limit: on the CPU at a test
size whose counts pass TF32's 2048, and on the card at each cell's own
size (``-m cuda``)."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import check, control, graph
from gpubench.reference.pathsim_f64 import PathSimF64
from gpubench.tests._tiny import REPO

LIMITS = {c["name"]: json.loads((REPO / c["file"]).read_text())["limits"]
          for c in json.loads((REPO / "BENCHMARK.json").read_text())[
              "configs"]}
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    x = torch.tensor([2048.0, 2049.0, 2050.0, 2051.0, 8710.0, 1.0])
    assert control.tf32(x).tolist() == [2048, 2048, 2050, 2052, 8712, 1]


@pytest.mark.parametrize("config", sorted(LIMITS))
def test_control_fails_at_test_size(config):
    size = {"authors": 64, "papers": 20000, "venues": 4}
    g = graph.synthetic_coo(size, 5)
    ref = PathSimF64(g["ap_rows"], g["ap_cols"], g["pv_rows"], g["pv_cols"],
                     64, 20000, 4)
    assert ref.c.max() > 2048  # TF32 rounds these counts
    rows = check.sample_rows(64, 5)
    checks, _ = check.compare([control.tf32_topk(g, rows, 10, "cpu")], rows,
                              ref, 10, LIMITS[config])
    assert not check.passed(checks)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(card, cell):
    checks, parts = control.control_reading(cell, 2**31 + 101, "cuda")
    assert not check.passed(checks), parts
