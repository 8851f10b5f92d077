"""The partition regime of the port's serving load generator
(``distributed_pathsim_tpu_torch.bench_serving.run_partition_smoke``) on
the CPU: three ``dpathsim-torch worker`` partition processes (chained
replication 2, ``--backend torch --platform cpu``) over a small graph.
Every gate is deterministic, so the smoke itself runs: answers
bit-identical to the single-host f64 oracle (top-k ids and scores and a
full scores row), routed deltas still exact, one mid-load SIGKILL with
zero lost requests and zero compiles added on the survivors, the
max-N model growing with the worker count, and a stitched trace with no
broken link."""

from distributed_pathsim_tpu_torch import bench_serving as bs


def test_partition_smoke_deterministic_checks():
    result = bs.run_partition_smoke(platform="cpu")
    checks = result["smoke_checks"]
    assert checks == bs.partition_checks(result)
    assert "partition" not in bs.CLOCK_CHECKS
    assert all(checks.values()), checks
    parts = result["partitions"]
    assert set(parts) == {"1", "3"}
    for p in parts.values():
        assert p["resident"]["factor_bytes"] > 0
        assert p["oracle_checked"]["checked"] == 12
    assert parts["3"]["routed_deltas"]["deltas"] == 3
    assert result["failover"]["failover_affected"] >= 0
    assert result["replica_baseline"]["lost"] == 0
