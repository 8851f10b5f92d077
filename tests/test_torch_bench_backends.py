"""The port's per-tier benchmark (``distributed_pathsim_tpu_torch.
bench_backends``) on the CPU: one JSON line per tier (``torch``,
``torch-sparse``, ``torch-sharded`` at D = 2), pairs/s > 0, and the three
tiers' rankings equal to each other and to the numpy backend's."""

import json

import numpy as np

from distributed_pathsim_tpu_torch import bench_backends as tbb
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

SHAPE = dict(n_authors=300, n_papers=500, n_venues=16)


def test_one_line_per_tier(capsys):
    rc = tbb.main(["--platform", "cpu", "--authors", "300", "--papers",
                   "500", "--venues", "16", "--repeats", "1"])
    assert rc == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.strip()]
    assert [rec["metric"] for rec in lines] == [
        f"author_pairs_per_sec_{tier}_300_authors_top10_cpu{dev}dev"
        for tier, dev in (("torch", 1), ("torch-sparse", 1),
                          ("torch-sharded", 2))
    ]
    for rec in lines:
        assert rec["unit"] == "pairs/sec"
        assert rec["value"] > 0
        assert rec["vs_baseline"] is None
        assert "device" not in rec  # the host names no card
    assert set(lines[2]["ring_step_ms"]) == {"plain_fold_cpu"}


def test_tier_rankings_equal_the_numpy_backend():
    """The tiers' rankings equal each other bit for bit (values and
    columns); against the numpy backend's f64 ranking the columns are
    equal and the f32 values within 1e-6."""
    hin = synthetic_hin(**SHAPE, seed=42)
    mp = compile_metapath("APVPA", hin.schema)
    want_v, want_i = create_backend("numpy", hin, mp).topk_rows(
        np.arange(SHAPE["n_authors"]), k=10)
    rankings = {}
    for tier in tbb.TIERS:
        *_, rankings[tier] = tbb.bench_backend(
            tier, hin, mp, k=10, repeats=1, n_devices=2, platform="cpu")
    first_v, first_i = rankings["torch"]
    for tier, (vals, idxs) in rankings.items():
        assert np.array_equal(vals, first_v), tier
        assert np.array_equal(idxs, first_i), tier
    assert np.array_equal(first_i, want_i)
    assert np.allclose(first_v, want_v, rtol=0, atol=1e-6)
