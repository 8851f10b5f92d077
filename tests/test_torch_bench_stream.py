"""The port's firehose and metapath load generators (``distributed_
pathsim_tpu_torch.bench_serving``) on the CPU, held against the
repository's harness (``bench_serving.py``) on the JAX package.

- The firehose smoke at the harness's smoke arguments: every check the
  clock does not decide (the update-visible and pause bounds are the
  clock's, asserted on the card by ``chip_smoke.py``'s phase 6i).
- The metapath ordering phase (host numpy f64 in both): the block
  shapes, the plan's order, its DP flag, its estimated FLOPs and the
  plan dump equal to the harness's.
- The metapath workload at the smoke's arguments: the mixed lanes
  bit-identical to the numpy oracles, zero recompiles, the sub-chain
  memo shared across lanes.
"""

import pytest

from distributed_pathsim_tpu_torch import bench_serving as bs
from torch_port_util import (  # noqa: F401  (untuned: an autouse fixture)
    assert_deterministic,
    jax_harness,
    untuned,
)

ORDERING_KEYS = ("metapath", "shapes", "plan_order", "dp_ran",
                 "est_flops_planner", "est_flops_naive", "est_speedup",
                 "bit_identical", "plan")


def test_firehose_smoke_checks_the_clock_does_not_decide():
    result = bs.run_firehose_bench(**bs.FIREHOSE_SMOKE, platform="cpu")
    checks = bs.firehose_checks(result)
    assert_deterministic(checks, "firehose")
    s = result["sustained"]
    assert s["deltas"] == bs.FIREHOSE_SMOKE["deltas"]
    assert s["compaction"]["failures"] == 0
    assert result["fleet"]["updates_ok"] == bs.FIREHOSE_SMOKE["fleet_updates"]
    actions = [d["action"] for d in result["autoscale"]["decisions"]]
    assert "spawn" in actions and "drain" in actions


@pytest.mark.parametrize("size", ["smoke", "default"])
def test_metapath_ordering_matches_the_jax_harness(size):
    c = bs.METAPATH_SMOKE
    args = ((c["n_authors"], c["n_papers"], c["n_venues"], c["n_topics"])
            if size == "smoke" else (2048, 4096, 12, 128))
    want = jax_harness()._metapath_ordering_phase(*args, 1, c["seed"])
    got = bs._metapath_ordering_phase(*args, 1, c["seed"])
    for key in ORDERING_KEYS:
        assert got[key] == want[key], key
    assert got["dp_ran"] and got["est_flops_planner"] < got["est_flops_naive"]


def test_metapath_workload_bit_identical_without_recompiles():
    result = bs.run_metapath_bench(**bs.METAPATH_SMOKE, platform="cpu")
    checks = bs.metapath_checks(result)
    assert checks == result["checks"]
    assert_deterministic(checks, "metapath")
    c = bs.METAPATH_SMOKE
    for arm in ("memo_on", "memo_off"):
        w = result["workload"][arm]
        assert w["bit_identical_vs_oracles"], arm
        assert w["steady_state_compiles"] == 0, arm
        assert w["queries"] == (c["clients"] * c["queries_per_client"]
                                * c["rounds"]), arm
    off = result["workload"]["memo_off"]["memo"]
    assert off is None or off["hits"] == 0
