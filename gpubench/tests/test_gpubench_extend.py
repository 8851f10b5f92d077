"""A later change adds a traffic op, a mix and an end-to-end metric as
new files and new entries of ``BENCHMARK.json``, and edits no file that is
there: the harness finds and runs them by name (on the CPU, with the
port's plain versions)."""

from __future__ import annotations

import json

import pytest

from gpubench import harness
from gpubench.tests._tiny import make_root

# a generator of another op: each call is one batched top-k of the rows
# that the seed draws, the row-by-row serving path
OP = '''
import numpy as np
from gpubench import check


class Op:
    def __init__(self, mix, cfg, seed, seconds):
        self.k = int(mix["k"])
        self.rows = check.sample_rows(int(cfg["graph"]["authors"]), seed)
        self.outputs = []

    def bind(self, backend, driver):
        return lambda: backend.topk_rows(self.rows, self.k)

    def keep(self, output):
        if not self.outputs:
            self.outputs.append(output)

    def compare(self, reference, limits, calls):
        return check.compare(self.outputs, self.rows, reference, self.k,
                             limits, calls)

    def record(self):
        return {"rows_per_call": int(self.rows.size)}
'''

# a new end-to-end metric: rows answered a second
METRIC = '''
def read(run):
    rows = run.get("rows_per_call")
    return None if rows is None else rows * run["calls"] / run["window_s"]
'''


def _add(root, *, faulty=False):
    (root / "gpubench/ops/topk_rows.py").write_text(
        OP.replace("self.outputs.append(output)",
                   "self.outputs.append((output[0], output[1] + 1))")
        if faulty else OP)
    (root / "gpubench/metrics/rows_per_s.py").write_text(METRIC)
    (root / "gpubench/traffic/rows.k10.json").write_text(
        json.dumps({"op": "topk_rows", "k": 10}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "rows_per_s", "unit": "rows/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock"})
    spec["workloads"].append({"name": "tinydense.rows.k10",
                              "config": "tinydense", "traffic": "rows.k10",
                              "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("faulty", [False, True])
def test_new_op_and_metric_added_as_files_alone(tmp_path, faulty):
    root = make_root(tmp_path)
    _add(root, faulty=faulty)
    rec = harness.run_cell(root, "tinydense.rows.k10", 2**31 + 9, 0.3, False,
                           "cpu")
    assert rec["correct"] is (not faulty)
    m = rec["metrics"]
    # the new metric reads in its cell, the rank-all rate (no pairs in
    # this op's record) is left out, the set-up time is there
    assert set(m) == {"rows_per_s", "setup_s"}
    assert m["rows_per_s"]["value"] > 0 and m["rows_per_s"]["unit"] == "rows/s"


def test_rank_all_cell_leaves_the_new_metric_out(tmp_path):
    root = make_root(tmp_path)
    _add(root)
    rec = harness.run_cell(root, "tinydense.rank-all.k10", 2**31 + 9, 0.3,
                           False, "cpu")
    assert rec["correct"] is True
    assert set(rec["metrics"]) == {"rank_all_pairs_per_s", "setup_s"}
