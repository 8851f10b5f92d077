"""BENCHMARK.json and the files each cell is found by."""

from __future__ import annotations

import json
import re

import pytest

from gpubench.harness import Bench
from gpubench.tests._tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    bench = Bench(REPO)
    w = bench.cell(cell)
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    assert hasattr(bench.op(bench.mix(w["traffic"])["op"]), "Op")
    assert hasattr(bench.reference(cfg["reference"]), "from_graph")
    for kind in ("end_to_end", "per_layer"):
        assert all(hasattr(bench.reader(m["name"]), "read")
                   for m in SPEC[kind])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / f"gpubench/traffic/{w['traffic']}.json").exists()
    for c in SPEC["configs"]:
        assert c["file"].startswith("gpubench/") and c["reduced"] == []
