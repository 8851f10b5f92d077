"""The port's compress and batch load generators (``distributed_
pathsim_tpu_torch.bench_serving``) on the CPU, held against the
repository's harness (``bench_serving.py``) on the JAX package.

- ``run_compress_bench`` at the smoke's arguments in both harnesses
  (``torch-sparse`` against ``jax-sparse``): per factor format the
  factor bytes (before and after the deltas), the nnz, the reduction
  against COO and the max-N model (single-chip and per-partition) equal
  to the harness's, and every format bit-identical to the COO arm; the
  smoke's checks.
- The batch smoke's checks, and the campaign's top-k on the smoke's
  sampled rows equal to the JAX package's campaign.
"""

import numpy as np
import pytest

from distributed_pathsim_tpu.batch import BatchEngine as JEngine
from distributed_pathsim_tpu.batch import run_topk_campaign as jtopk
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu_torch import bench_serving as bs
from distributed_pathsim_tpu_torch.batch import (
    BatchEngine,
    run_topk_campaign,
)
from torch_port_util import (  # noqa: F401  (untuned: an autouse fixture)
    assert_deterministic,
    jax_harness,
    metapaths,
    port_hin,
    untuned,
    untuned_packages,
)

EXACT_KEYS = ("factor_bytes", "factor_nnz", "coo_equiv_bytes",
              "factor_bytes_post_delta", "resident_bytes_per_author",
              "max_n_at_budget_single_chip", "partition",
              "bit_identical_to_coo")


@pytest.fixture(scope="module")
def compress_runs():
    with untuned_packages():
        want = jax_harness().run_compress_bench(**bs.COMPRESS_SMOKE)
        got = bs.run_compress_bench(**bs.COMPRESS_SMOKE, platform="cpu")
    return want, got


@pytest.mark.parametrize("fmt", ["coo", "blocked", "bitpacked"])
def test_compress_format_matches_the_jax_harness(compress_runs, fmt):
    want, got = compress_runs
    w, g = want["formats"][fmt], got["formats"][fmt]
    assert set(g) == set(w)
    for key in EXACT_KEYS + (("reduction_vs_coo",) if fmt != "coo" else ()):
        assert g[key] == w[key], key
    assert g["bit_identical_to_coo"]
    assert g["steady_state_compiles"] == g["delta_phase_compiles"] == 0


def test_compress_smoke_checks(compress_runs):
    want, got = compress_runs
    assert got["summary"] == want["summary"]
    checks = bs.compress_checks(got)
    assert_deterministic(checks, "compress")
    assert all(checks.values()), checks


def test_batch_smoke_checks_and_sampled_topk_match_jax():
    c = bs.BATCH_SMOKE
    result = bs.run_batch_bench(**c, platform="cpu")
    assert_deterministic(result["checks"], "batch")
    assert all(result["checks"].values()), result["checks"]
    assert result["backend_mode"] == "numpy"  # the host arm on the CPU
    # the campaign the bench ran, against the JAX package's, on the rows
    # the bench samples (its first draw from the seeded generator)
    jhin = jsyn(c["n_authors"], c["n_papers"], c["n_venues"], seed=c["seed"])
    graphs = (jhin, port_hin(jhin))
    jmp, tmp = metapaths(graphs)
    got = run_topk_campaign(BatchEngine(graphs[1], tmp, device="cpu",
                                        block_rows=c["block_rows"]), c["k"])
    want = jtopk(JEngine(jhin, jmp, block_rows=c["block_rows"]), c["k"])
    n = jhin.type_size("author")
    sample = np.sort(np.random.default_rng(c["seed"]).choice(
        n, size=min(c["sample_rows"], n), replace=False))
    assert np.array_equal(got.vals[sample], want.vals[sample])
    assert np.array_equal(got.idxs[sample], want.idxs[sample])
    assert np.array_equal(got.vals, want.vals)
