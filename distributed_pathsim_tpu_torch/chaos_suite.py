"""Chaos suite: the port's tier-1 tests under a fixed fault-injection
schedule.

    python -m distributed_pathsim_tpu_torch.chaos_suite [--ambient | --targeted | --router]

The twin of the repository's ``scripts/chaos_suite.py`` for the port:
the same plans, passes, flags and child environment, over the port's
tier-1 files (``tests/test_torch_*.py``) in place of ``tests/``.

1. **Targeted**: the ``chaos``-marked recovery tests with their own
   per-test plans (these also run in plain tier-1).
2. **Ambient**: every port test under ``PATHSIM_FAULT_PLAN`` injecting
   transient failures at every retried seam. The suite must still pass:
   retries make one-off seam failures invisible to every caller, so a
   test that breaks under the ambient plan has found port code that
   crosses a seam outside the resilience layer.
3. **Router** (``--router`` alone): the ``chaos`` tests whose names say
   ``router`` under :data:`ROUTER_PLAN`.

The schedule is fixed (deterministic rules, deterministic jitter via
``PATHSIM_RETRY_SEED``): a chaos failure reproduces by re-running this
module, not by chasing a random seed.

It runs on the CPU only: the port's tests hold it against the JAX
package, which they import as their reference, so the child sets
``JAX_PLATFORMS=cpu`` (an environment string; this module imports no
JAX). The machine with the card has no JAX, and there ``chip_smoke.py``
holds the ``backend_init`` and ``tile_execute`` seams on the card.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

# One transient failure at every retried seam, plus a torn checkpoint
# write and a slow backend init. Counts are small on purpose: each rule
# is consumed by the first tests that cross its seam, proving recovery
# there; the rest of the suite then runs clean.
AMBIENT_PLAN = ",".join(
    [
        "gexf_load:error:1",
        "metapath_compile:error:1",
        "backend_init:error:1",
        "backend_init:delay:1:0.05",
        "tile_execute:error:2",
        "device_execute:error:1",
        "checkpoint_write:error:1",
        "checkpoint_write:partial:1",
        "multihost_init:error:1",
    ]
)

# The horizontal tier's plan: transient per-request dispatch failures, a
# worker stall, dropped heartbeats and a missed delta broadcast, on top
# of the mid-batch SIGKILL the router chaos tests perform themselves.
ROUTER_PLAN = ",".join(
    [
        "worker_dispatch:error:3",
        "worker_dispatch:delay:1:0.05",
        "heartbeat:error:2",
        "delta_broadcast:error:1@1",
    ]
)

BASE_ARGS = [
    "-m",
    "pytest",
    "-q",
    "--continue-on-collection-errors",
    "-p",
    "no:cacheprovider",
    "-p",
    "no:xdist",
    "-p",
    "no:randomly",
]

# name -> (label, pytest selection, extra child environment)
PASSES = {
    "targeted": ("targeted (chaos-marked tests, per-test plans)",
                 ["-m", "chaos and not slow"], {}),
    "ambient": ("ambient (the port's tier-1 under PATHSIM_FAULT_PLAN)",
                ["-m", "not slow"], {"PATHSIM_FAULT_PLAN": AMBIENT_PLAN}),
    "router": ("router (horizontal tier under ROUTER_PLAN)",
               ["-m", "chaos and not slow", "-k", "router"],
               {"PATHSIM_FAULT_PLAN": ROUTER_PLAN}),
}


def port_test_files() -> list[str]:
    """The port's tier-1 files, relative to the repository root."""
    return sorted(p.relative_to(REPO).as_posix()
                  for p in REPO.glob("tests/test_torch_*.py"))


def pass_argv(name: str) -> list[str]:
    """The child's command line for pass ``name``."""
    return [sys.executable, *BASE_ARGS, *port_test_files(), *PASSES[name][1]]


def pass_env(name: str) -> dict:
    """The child's environment for pass ``name``: this process's, with
    the host platform for the JAX reference, fast deterministic backoff,
    and the pass's plan."""
    env = os.environ.copy()
    env.setdefault("JAX_PLATFORMS", "cpu")
    # fast, deterministic backoff: chaos runs should not sleep
    env.setdefault("PATHSIM_RETRY_BASE_DELAY", "0.001")
    env.setdefault("PATHSIM_RETRY_SEED", "0")
    env.update(PASSES[name][2])
    return env


def selected_passes(argv=None) -> list[str]:
    """The passes the flags select, in run order."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--ambient", action="store_true",
                       help="ambient pass only")
    group.add_argument("--targeted", action="store_true",
                       help="targeted pass only")
    group.add_argument("--router", action="store_true",
                       help="router pass only (the horizontal tier "
                       "under ROUTER_PLAN)")
    args = ap.parse_args(argv)
    if args.router:
        return ["router"]
    return [name for name, skip in (("targeted", args.ambient),
                                    ("ambient", args.targeted)) if not skip]


def _run(name: str) -> int:
    label = PASSES[name][0]
    print(f"== chaos_suite: {label} ==", flush=True)
    rc = subprocess.call(pass_argv(name), cwd=str(REPO), env=pass_env(name))
    print(f"== chaos_suite: {label} -> exit {rc} ==", flush=True)
    return rc


def main(argv=None) -> int:
    rc = 0
    for name in selected_passes(argv):
        rc |= _run(name)
    return rc


if __name__ == "__main__":
    sys.exit(main())
