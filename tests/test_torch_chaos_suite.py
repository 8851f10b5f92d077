"""The port's chaos suite (``distributed_pathsim_tpu_torch.chaos_suite``)
against the repository's ``scripts/chaos_suite.py``: the same plans, each
of whose seams the port's injector knows; the same passes, flags,
markers and child environment over the port's tier-1 files alone; a port
``chaos`` counterpart for each of the JAX package's ``chaos`` tests; and
the router pass run as a program."""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest

from distributed_pathsim_tpu_torch import chaos_suite
from distributed_pathsim_tpu_torch.resilience import inject

REPO = pathlib.Path(__file__).resolve().parent.parent

# Each JAX chaos test → its port counterpart.
COUNTERPARTS = {
    "tests/test_resilience.py::test_load_seam_retries_and_succeeds":
        "tests/test_torch_resilience.py::test_load_seam_retries_and_succeeds",
    "tests/test_resilience.py::test_tile_seam_injection_is_absorbed":
        "tests/test_torch_resilience_batch.py::"
        "test_tile_and_checkpoint_faults_are_retried"
        "[tile_execute:error:2-tile_execute]",
    "tests/test_resilience.py::test_backend_init_degrades_down_the_chain":
        "tests/test_torch_resilience_batch.py::"
        "test_backend_init_fault_degrades_with_the_same_answer",
    "tests/test_resilience.py::test_partial_write_retried_and_atomic":
        "tests/test_torch_resilience.py::"
        "test_partial_write_retried_and_atomic",
    "tests/test_resilience.py::"
    "test_midtile_crash_resume_is_exact_and_skips_done_units":
        "tests/test_torch_resilience.py::"
        "test_midtile_crash_resume_is_exact_and_skips_done_units",
    "tests/test_resilience.py::test_preemption_flushes_and_resumes_exactly":
        "tests/test_torch_resilience.py::"
        "test_preemption_flushes_and_resumes_exactly",
    "tests/test_resilience.py::test_ring_preemption_flushes_and_resumes":
        "tests/test_torch_sharded.py::"
        "test_mid_ring_resume_after_a_kill_at_any_step",
    "tests/test_resilience.py::test_full_run_with_a_fault_at_every_seam":
        "tests/test_torch_resilience.py::"
        "test_full_run_with_a_fault_at_every_seam",
    "tests/test_resilience.py::test_cli_preempted_exit_code_and_resume":
        "tests/test_torch_resilience_batch.py::"
        "test_preempted_sweep_exits_75_and_resumes_identically",
    "tests/test_router.py::test_chaos_router_smoke":
        "tests/test_torch_router_smoke.py::test_chaos_router_smoke",
    "tests/test_router.py::test_router_ann_failover_to_exact_replica":
        "tests/test_torch_ann_router.py::"
        "test_ann_failover_to_an_exact_only_replica",
    "tests/test_router.py::test_router_learned_failover_to_towerless_replica":
        "tests/test_torch_learned_router.py::"
        "test_router_learned_failover_to_a_towerless_replica",
    # the port's test kills a holder mid-batch, then seals an update with
    # the dead holder: both JAX partition chaos tests in one fleet
    "tests/test_partition.py::test_partition_router_kill_mid_batch_zero_lost":
        "tests/test_torch_partition.py::"
        "test_worker_killed_mid_batch_loses_nothing",
    "tests/test_partition.py::test_partition_router_update_with_dead_worker":
        "tests/test_torch_partition.py::"
        "test_worker_killed_mid_batch_loses_nothing",
    "tests/test_firehose.py::test_kill_worker_mid_compaction":
        "tests/test_torch_firehose.py::test_kill_worker_mid_compaction",
}
# Port chaos tests with no JAX chaos twin of their own.
PORT_ONLY = {
    "tests/test_torch_resilience_batch.py::"
    "test_tile_and_checkpoint_faults_are_retried"
    "[checkpoint_write:partial:1-checkpoint_write]",
    "tests/test_torch_partition.py::"
    "test_missed_broadcast_is_fenced_then_replayed",
}


@pytest.fixture(scope="module")
def jax_suite():
    spec = importlib.util.spec_from_file_location(
        "chaos_suite_jax", REPO / "scripts" / "chaos_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _collect(argv) -> set[str]:
    """The node ids pytest selects with ``argv`` (one ``-v`` against the
    two ``-q`` of the suite and the settings, so ids are listed)."""
    out = subprocess.run(
        [*argv, "--collect-only", "-v"], capture_output=True, text=True,
        timeout=300, cwd=str(REPO), env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return {line for line in out.stdout.splitlines() if "::" in line}


def test_plans_equal_the_jax_suite_and_name_known_seams(jax_suite):
    assert chaos_suite.AMBIENT_PLAN == jax_suite.AMBIENT_PLAN
    assert chaos_suite.ROUTER_PLAN == jax_suite.ROUTER_PLAN
    for plan in (chaos_suite.AMBIENT_PLAN, chaos_suite.ROUTER_PLAN):
        rules = inject.parse_plan(plan)
        assert len(rules) == plan.count(",") + 1
        assert {r.seam for r in rules} <= set(inject.SEAMS)


@pytest.mark.parametrize("flags", [[], ["--ambient"], ["--targeted"],
                                   ["--router"]])
def test_passes_select_the_port_files_with_the_jax_markers(
        jax_suite, monkeypatch, flags):
    """Each flag runs the JAX suite's passes in its order, with its pytest
    arguments and plans, over ``tests/test_torch_*.py`` in place of
    ``tests/``."""
    def calls_of(main) -> list:
        calls = []

        def call(argv, cwd, env):
            calls.append((argv, env))
            return 0

        monkeypatch.setattr(subprocess, "call", call)
        assert main(flags) == 0
        return calls

    jax_calls = calls_of(jax_suite.main)
    port_calls = calls_of(chaos_suite.main)
    assert len(port_calls) == len(jax_calls) == (1 if flags else 2)
    files = chaos_suite.port_test_files()
    assert len(files) > 80 and all(
        re.fullmatch(r"tests/test_torch_\w+\.py", f) for f in files)
    for (pargv, penv), (jargv, jenv) in zip(port_calls, jax_calls):
        assert [a for a in pargv if a not in files] == [
            a for a in jargv if a != "tests/"]
        assert [a for a in pargv if a.endswith(".py")] == files
        for key in ("JAX_PLATFORMS", "PATHSIM_RETRY_BASE_DELAY",
                    "PATHSIM_RETRY_SEED", "PATHSIM_FAULT_PLAN"):
            assert penv.get(key) == jenv.get(key), key


def test_every_jax_chaos_test_has_a_port_counterpart():
    jax_files = sorted(
        p.relative_to(REPO).as_posix() for p in REPO.glob("tests/test_*.py")
        if not p.name.startswith("test_torch_")
        and "mark.chaos" in p.read_text())
    jax_ids = _collect([sys.executable, "-m", "pytest", *jax_files, "-q",
                        "-p", "no:cacheprovider", "-m", "chaos and not slow"])
    assert jax_ids == set(COUNTERPARTS) and len(jax_ids) == 15
    port_ids = _collect(chaos_suite.pass_argv("targeted"))
    assert set(COUNTERPARTS.values()) <= port_ids
    assert port_ids == set(COUNTERPARTS.values()) | PORT_ONLY


def test_router_pass_exits_zero():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.chaos_suite",
         "--router"], capture_output=True, text=True, timeout=600,
        cwd=str(REPO),
    )
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert "router (horizontal tier under ROUTER_PLAN) -> exit 0" in out.stdout
