"""The port's graft entry (``distributed_pathsim_tpu_torch.graft_entry``)
against the repository's ``__graft_entry__.py`` on the CPU: the forward
step at tolerance 0 (integer counts below 2²⁴, a correctly rounded f32
division on both sides), the dry run at D = 1, 2, 4 and 8 virtual shards
of the host without touching the card, each item's arrays at D = 4
against the JAX package's same functions on 4 of the 8 virtual XLA
devices (tests/conftest.py; the ring's forced kernel as its plain
version against the Pallas step in interpret mode), the resume's step
count, and the module run as a program."""

import importlib.util
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsynthetic
from distributed_pathsim_tpu.models.multipath import (
    MultiMetapathScorer as JScorer,
)
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu.parallel import sharded as jsh
from distributed_pathsim_tpu.parallel.mesh import make_mesh as jmesh
from distributed_pathsim_tpu.parallel.mesh import make_mesh_2d as jmesh_2d
from distributed_pathsim_tpu.parallel.tiling import (
    place_2d as jplace_2d,
    tiled_scores_2d as jscores_2d,
    tiled_topk_2d as jtopk_2d,
)
from distributed_pathsim_tpu_torch import graft_entry
from distributed_pathsim_tpu_torch.utils.device import DeviceUnavailable

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_jax", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dryrun4():
    return graft_entry.dryrun_multichip(4, platform="cpu")


def test_entry_forward_equals_jax_at_tolerance_zero(jax_entry):
    jfn, jargs = jax_entry.entry()
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               for a in args)
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    got = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_on_the_host_never_touches_the_card(n):
    report = graft_entry.dryrun_multichip(n, platform="cpu")
    assert not torch.cuda.is_initialized()
    # the host runs the kernels' plain versions: no launch is counted
    assert set(report["launches"].values()) == {0}
    assert report["launches_1c"] == report["launches"]
    assert report["arrays"]["m"].shape == (8 * n, 8 * n)


def test_resume_runs_the_steps_left(dryrun4):
    """Preempted after ring step 0, the resume runs D − 1 steps (with one
    shard the first run finishes and the resume runs none)."""
    assert dryrun4["resume_steps"] == 3
    assert graft_entry.dryrun_multichip(2, platform="cpu")[
        "resume_steps"] == 1
    assert graft_entry.dryrun_multichip(1, platform="cpu")[
        "resume_steps"] == 0


def test_items_equal_the_jax_functions_at_four_shards(jax_entry, dryrun4):
    got = dryrun4["arrays"]
    n = 32
    blocks = jax_entry._small_blocks(np.float32, n_authors=n, n_papers=64)
    mesh = jmesh(4)
    first = jsh.shard_first_block_rows(blocks[0], mesh)
    rest = tuple(jsh.replicate(b, mesh) for b in blocks[1:])
    # 1. the chain's M and row sums
    m, rs = jsh.sharded_chain_outputs(first, rest, mesh=mesh,
                                      allpairs_strategy="ring")
    np.testing.assert_array_equal(got["m"], np.asarray(m))
    np.testing.assert_array_equal(got["rowsums"], np.asarray(rs))
    # 1b. the ring's top-k; 1c. forced onto the kernel, and diagonal
    for key, kw in (("topk", {}), ("topk_kernel", {"use_pallas": True})):
        v, i = jsh.sharded_topk(first, rest, mesh=mesh, k=3, n_true=n, **kw)
        np.testing.assert_array_equal(got[key][0], np.asarray(v))
        np.testing.assert_array_equal(got[key][1], np.asarray(i))
    vd, _ = jsh.sharded_topk(first, rest, mesh=mesh, k=3, n_true=n,
                             variant="diagonal")
    np.testing.assert_array_equal(got["topk_diagonal"], np.asarray(vd))
    # 2. the (2, 2) mesh's tiles and top-k
    mesh2 = jmesh_2d((2, 2))
    c = np.asarray(blocks[0] @ blocks[1], dtype=np.float32)
    d = np.asarray(c @ c.sum(axis=0), dtype=np.float32)
    args = jplace_2d(c, d, mesh2)
    np.testing.assert_array_equal(got["scores_2d"],
                                  np.asarray(jscores_2d(*args, mesh=mesh2)))
    v2, i2 = jtopk_2d(*args, mesh=mesh2, k=3, n_true=n)
    np.testing.assert_array_equal(got["topk_2d"][0], np.asarray(v2))
    np.testing.assert_array_equal(got["topk_2d"][1], np.asarray(i2))
    # 2b. the sharded ensemble
    hin = jsynthetic(n, 64, 12, seed=0)
    mv, mi = JScorer(hin, ["APVPA", "APA"]).topk_sharded(k=3, n_devices=4)
    np.testing.assert_array_equal(got["ensemble"][0], mv)
    np.testing.assert_array_equal(got["ensemble"][1], mi)
    # 4b. the jax-sharded backend's M
    backend = jcreate("jax-sharded", hin, jcompile("APVPA", hin.schema),
                      n_devices=4)
    np.testing.assert_array_equal(got["backend_m"],
                                  backend.commuting_matrix())


def test_refuses_without_a_card_unless_the_host_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        graft_entry.main([])
    with pytest.raises(DeviceUnavailable):
        graft_entry.entry()
    with pytest.raises(DeviceUnavailable):
        graft_entry.dryrun_multichip(2)


def test_module_runs_as_a_program_on_the_host():
    out = subprocess.run(
        [sys.executable, "-m", "distributed_pathsim_tpu_torch.graft_entry",
         "--platform", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["entry: (64, 64)",
                                       "dryrun_multichip(4): ok"]
