"""The port's serving load generator (``distributed_pathsim_tpu_torch.
bench_serving``) on the CPU, held against the repository's harness
(``bench_serving.py``) on the JAX package.

- The load and obs smokes' deterministic checks, through the shared
  check builders (the clock's checks run on the card, in
  ``chip_smoke.py``'s phase 6h).
- ``run_bench`` and ``run_update_bench`` at 128 authors through both
  harnesses on one seed: equal key trees, and equal fields the clock
  does not decide (the load regime's queries and sheds, the update
  regime's retention block and delta stats).
- Without a card and without ``--platform cpu`` the twins exit 2 and
  print nothing; the regimes not ported yet are argparse errors.
"""

import pathlib
import sys

import pytest

from distributed_pathsim_tpu_torch import bench_backends as tbb
from distributed_pathsim_tpu_torch import bench_serving as bs

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(n_authors=128, n_papers=200, n_venues=8)


def _jax_harness():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import bench_serving

    return bench_serving


def _key_tree(d, prefix=""):
    """Every key path of a result. A ``buckets`` histogram is a leaf:
    its keys are the batch sizes that formed, which the clock decides."""
    out = set()
    if isinstance(d, dict):
        for key, value in d.items():
            path = f"{prefix}/{key}"
            out.add(path)
            if key != "buckets":
                out |= _key_tree(value, path)
    return out


def _assert_deterministic(checks, regime):
    clock = bs.CLOCK_CHECKS.get(regime, ())
    assert set(clock) <= set(checks)
    failed = [name for name, ok in checks.items()
              if name not in clock and not ok]
    assert not failed, checks


def test_load_smoke_deterministic_checks():
    result = bs.run_bench(**bs.LOAD_SMOKE, platform="cpu")
    checks = bs.load_checks(result)
    _assert_deterministic(checks, "load")
    total = bs.LOAD_SMOKE["clients"] * bs.LOAD_SMOKE["queries_per_client"]
    for name, regime in result["regimes"].items():
        assert regime["queries"] == total, name
    assert result["regimes"]["warm"]["cache"]["hits"] > 0


def test_run_bench_matches_the_jax_harness():
    load = dict(TINY, clients=4, queries_per_client=8, max_batch=8)
    want = _jax_harness().run_bench(**load, backend="jax")
    got = bs.run_bench(**load, platform="cpu")
    assert _key_tree(got) == _key_tree(want)
    assert got["backend"] == "torch" and want["backend"] == "jax"
    for name in ("serial", "cold", "warm", "mixed"):
        for key in ("queries", "shed"):
            assert got["regimes"][name][key] == want["regimes"][name][key]
        assert got["regimes"][name]["service"]["shed"] == 0


def test_run_update_bench_matches_the_jax_harness():
    want = _jax_harness().run_update_bench(**TINY, reps=2, backend="jax")
    got = bs.run_update_bench(**TINY, reps=2, platform="cpu")
    assert _key_tree(got) == _key_tree(want)
    assert got["cache_retention"] == want["cache_retention"]
    assert got["service"] == want["service"]
    assert got["service"]["rebuilds"] == 0
    checks = bs.update_checks(got)
    _assert_deterministic(checks, "update")


def test_obs_smoke_deterministic_checks():
    result = bs.run_obs_bench(**bs.OBS_SMOKE, platform="cpu")
    checks = bs.obs_checks(result)
    _assert_deterministic(checks, "obs")
    assert set(result["arms"]) == {"off", "metrics", "sampled", "traced"}
    audit = result["arms"]["traced"]["trace_audit"]
    assert audit["broken_parent_links"] == 0
    assert audit["dispatched_request_traces"] > 0


def test_no_card_exits_2_and_prints_nothing(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert bs.main(["--smoke"]) == 2
    assert tbb.main(["--repeats", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_regimes_of_the_next_slice_are_refused(capsys):
    for regime in ("ann", "learned", "firehose", "metapath", "compress",
                   "batch"):
        with pytest.raises(SystemExit) as exc:
            bs.main(["--regime", regime, "--platform", "cpu"])
        assert exc.value.code == 2, regime
        assert "invalid choice" in capsys.readouterr().err, regime
