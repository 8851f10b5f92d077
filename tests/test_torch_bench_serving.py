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
  print nothing; the twin's regimes are the harness's twelve.
"""

import ast

import pytest

from distributed_pathsim_tpu_torch import bench_backends as tbb
from distributed_pathsim_tpu_torch import bench_serving as bs
from torch_port_util import REPO, assert_deterministic, jax_harness, key_tree

TINY = dict(n_authors=128, n_papers=200, n_venues=8)


def test_load_smoke_deterministic_checks():
    result = bs.run_bench(**bs.LOAD_SMOKE, platform="cpu")
    checks = bs.load_checks(result)
    assert_deterministic(checks, "load")
    total = bs.LOAD_SMOKE["clients"] * bs.LOAD_SMOKE["queries_per_client"]
    for name, regime in result["regimes"].items():
        assert regime["queries"] == total, name
    assert result["regimes"]["warm"]["cache"]["hits"] > 0


def test_run_bench_matches_the_jax_harness():
    load = dict(TINY, clients=4, queries_per_client=8, max_batch=8)
    want = jax_harness().run_bench(**load, backend="jax")
    got = bs.run_bench(**load, platform="cpu")
    assert key_tree(got) == key_tree(want)
    assert got["backend"] == "torch" and want["backend"] == "jax"
    for name in ("serial", "cold", "warm", "mixed"):
        for key in ("queries", "shed"):
            assert got["regimes"][name][key] == want["regimes"][name][key]
        assert got["regimes"][name]["service"]["shed"] == 0


def test_run_update_bench_matches_the_jax_harness():
    want = jax_harness().run_update_bench(**TINY, reps=2, backend="jax")
    got = bs.run_update_bench(**TINY, reps=2, platform="cpu")
    assert key_tree(got) == key_tree(want)
    assert got["cache_retention"] == want["cache_retention"]
    assert got["service"] == want["service"]
    assert got["service"]["rebuilds"] == 0
    checks = bs.update_checks(got)
    assert_deterministic(checks, "update")


def test_obs_smoke_deterministic_checks():
    result = bs.run_obs_bench(**bs.OBS_SMOKE, platform="cpu")
    checks = bs.obs_checks(result)
    assert_deterministic(checks, "obs")
    assert set(result["arms"]) == {"off", "metrics", "sampled", "traced"}
    audit = result["arms"]["traced"]["trace_audit"]
    assert audit["broken_parent_links"] == 0
    assert audit["dispatched_request_traces"] > 0


def test_no_card_exits_2_and_prints_nothing(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert bs.main(["--smoke"]) == 2
    assert bs.main(["--regime", "learned", "--smoke"]) == 2
    assert tbb.main(["--repeats", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_regimes_equal_the_jax_harness_choices():
    """The twin's ``REGIMES`` are the repository harness's ``--regime``
    choices, in its order, read off its argparse call by AST."""
    tree = ast.parse((REPO / "bench_serving.py").read_text())
    choices = next(
        kw.value for node in ast.walk(tree) if isinstance(node, ast.Call)
        and node.args and isinstance(node.args[0], ast.Constant)
        and node.args[0].value == "--regime"
        for kw in node.keywords if kw.arg == "choices")
    assert bs.REGIMES == ast.literal_eval(choices)
    assert len(bs.REGIMES) == 12
