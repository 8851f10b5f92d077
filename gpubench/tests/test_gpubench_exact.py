"""The exact configuration's pieces: the plain reference in PyTorch
against the NumPy one, the ``rank_all_exact`` op's ``column_mismatch``
check, and a cell of an exact configuration found by name and run (on
the CPU, with the port's plain versions, on a graph past 2^24)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gpubench import graph, harness
from gpubench.ops import rank_all
from gpubench.ops.rank_all_exact import Op
from gpubench.reference import pathsim_f64, pathsim_torch_f64
from gpubench.tests._tiny import REPO, TINY, make_root

CELL = "synth1m-dense-exact.rank-all-exact.k10"


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed,k", [(3, 10), (2**33 + 1, 20)])
def test_torch_reference_equals_numpy_reference(name, seed, k):
    g = graph.synthetic_coo(TINY[name][0], seed)
    a, b = pathsim_f64.from_graph(g), pathsim_torch_f64.from_graph(g)
    assert np.array_equal(a.c, b.c.numpy()) and np.array_equal(a.d,
                                                             b.d.numpy())
    rows = np.arange(g["authors"])
    (av, ai), (bv, bi) = a.topk(rows, k), b.topk(rows, k)
    assert np.array_equal(av, bv) and np.array_equal(ai, bi)
    cols = np.random.default_rng(seed).integers(0, g["authors"],
                                                (rows.size, 3))
    r2 = np.broadcast_to(rows[:, None], cols.shape)
    assert np.array_equal(a.scores(r2, cols), b.scores(r2, cols))


def _reference(c):
    """pathsim_torch_f64's reference of the factor ``c`` itself."""
    ref = pathsim_torch_f64.PathSimTorchF64.__new__(
        pathsim_torch_f64.PathSimTorchF64)
    ref.c = torch.tensor(c, dtype=torch.float64)
    ref.d = ref.c @ ref.c.sum(0)
    ref.n = len(c)
    return ref


def _checks(ref, vals, idxs, k, calls=2):
    op = Op({"op": "rank_all_exact", "k": k},
            {"graph": {"authors": ref.n, "venues": 2}}, 2**31 + 1, 1.0)
    assert np.array_equal(op.rows, np.arange(ref.n))
    for _ in range(calls):
        op.keep((vals, idxs))
    checks, _ = op.compare(ref, {"rank_gap": 0.0, "column_mismatch": 0},
                           calls)
    return {name: c["value"] for name, c in checks.items()}


def test_column_mismatch_catches_a_tie_swapped_across_rank_k():
    """Rows 1-3 of the factor are equal, so row 0 scores them alike: a
    program that keeps column 2 at rank 1 has every value right (rank_gap
    0) and the wrong column, once in each of 2 calls."""
    ref = _reference([[3, 1], [1, 0], [1, 0], [1, 0], [0, 2]])
    vals, idxs = ref.topk(np.arange(5), 1)
    assert idxs[0, 0] == 1 and ref.scores([0], [2])[0] == vals[0, 0]
    assert _checks(ref, vals, idxs, 1) == {"rank_gap": 0.0,
                                           "column_mismatch": 0}
    swapped = idxs.copy()
    swapped[0, 0] = 2
    assert _checks(ref, vals, swapped, 1) == {"rank_gap": 0.0,
                                              "column_mismatch": 2}


def test_f32_output_fails_both_checks():
    """The scores of counts past 2^24 computed in f32 (counts, sums and
    quotient, as --approx does): rounded values read a rank_gap above 0,
    and a near tie that f32 makes a tie goes to the lower column, which
    column_mismatch reads."""
    c = [[2573629, 0], [6309611, 0], [6309612, 0], [1, 3], [2, 5]]
    ref = _reference(c)
    m = ref.c @ ref.c.T
    s = (2 * m.float()) / (ref.d.float()[:, None] + ref.d.float()[None, :])
    s.fill_diagonal_(-torch.inf)
    v32, i32 = torch.sort(s, dim=1, descending=True, stable=True)
    vals, idxs = v32[:, :1].double().numpy(), i32[:, :1].numpy()
    assert ref.topk(np.arange(5), 1)[1][0, 0] == 2 and idxs[0, 0] == 1
    got = _checks(ref, vals, idxs, 1, calls=3)
    assert got["rank_gap"] > 0.0 and got["column_mismatch"] >= 3


def _exact_root(tmp_path):
    """The repository's benchmark with a test-size exact configuration:
    40 authors over 200,000 papers, so the Zipf head's row sums pass
    2^24, under the new mix."""
    root = make_root(tmp_path)
    cfg = json.loads((REPO / "gpubench/configs/synth1m-dense-exact.json")
                     .read_text())
    cfg.update(name="tinyexact", graph={"authors": 40, "papers": 200000,
                                        "venues": 2, "authors_per_paper": 1.3})
    (root / "gpubench/configs/tinyexact.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinyexact", "source": "test",
                            "reduced": [], "why": "test",
                            "file": "gpubench/configs/tinyexact.json"})
    spec["workloads"].append({"name": "tinyexact.rank-all-exact.k10",
                              "config": "tinyexact",
                              "traffic": "rank-all-exact.k10", "chips": 1,
                              "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_exact_cell_resolves_through_bench():
    bench = harness.Bench(REPO)
    w = bench.cell(CELL)
    cfg = bench.config(w["config"])
    assert (w["chips"], cfg["backend"], cfg["backend_options"]) == (
        1, "torch", {"exact_counts": True})
    assert cfg["limits"] == {"rank_gap": 0.0, "column_mismatch": 0}
    mix = bench.mix(w["traffic"])
    assert (mix["op"], mix["k"]) == ("rank_all_exact", 10)
    assert issubclass(bench.op(mix["op"]).Op, rank_all.Op)
    assert bench.reference(cfg["reference"]).from_graph is not None
    layer = {m["name"]: m for m in bench.spec["per_layer"]}
    for name in ("exact_pass2_ms", "exact_f64_scores_per_row"):
        assert layer[name]["workloads"] == [CELL]
        assert bench.reader(name).read({"calls": 0, "n": 0}) is None


@pytest.mark.parametrize("fault", [None, "f32", "swap"])
def test_exact_cell_runs_and_reads_its_faults(tmp_path, monkeypatch, fault):
    """A cell of an exact configuration past 2^24 runs the exact path
    (its plain version here) and reads correct; the exact wrapper's
    values rounded to f32, or two of its columns swapped, read not
    correct."""
    from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

    real = ck.fused_topk_twopass_exact

    def broken(*args, **kwargs):
        vals, idxs = real(*args, **kwargs)
        if fault == "f32":
            return vals.float().double(), idxs
        idxs = idxs.clone()
        idxs[0, -2:] = idxs[0, -2:].flip(0)  # rank k's column moved up
        return vals, idxs

    if fault:
        monkeypatch.setattr(ck, "fused_topk_twopass_exact", broken)
    rec = harness.run_cell(_exact_root(tmp_path), "tinyexact.rank-all-exact.k10",
                           2**31 + 77, 0.3, False, "cpu")
    checks = {n: c["value"] for n, c in rec["checks"].items()}
    assert set(rec["metrics"]) == {"rank_all_pairs_per_s", "setup_s"}
    if fault is None:
        assert rec["correct"] is True
        assert checks == {"rank_gap": 0.0, "column_mismatch": 0}
    else:
        assert rec["correct"] is False
        assert checks["column_mismatch"] > 0 or checks["rank_gap"] > 0
