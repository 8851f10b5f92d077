"""The port's fault-tolerant execution under injected failure, on the CPU:
the ``chaos`` counterparts of tests/test_resilience.py's recovery tests
that the port's batch-CLI file (test_torch_resilience_batch.py) does not
already hold — a load seam retried, a torn checkpoint write retried and
never left behind, a ``torch-sparse`` rank-all crashed mid-tile and
resumed without redoing its finished tiles, a preemption flushed and
resumed, and a whole run with one transient fault at every seam. Every
ranking is held, tolerance 0, to the clean port run and to the JAX
package's ``jax-sparse`` on the same graph."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.driver import PathSimDriver as JDriver
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.config import RunConfig
from distributed_pathsim_tpu_torch.data.synthetic import write_gexf
from distributed_pathsim_tpu_torch.driver import PathSimDriver
from distributed_pathsim_tpu_torch.engine import build, load_dataset
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.resilience import (
    InjectedCrash,
    Preempted,
    inject,
)
from distributed_pathsim_tpu_torch.resilience.preemption import (
    handler as preemption_handler,
)
from distributed_pathsim_tpu_torch.utils.checkpoint import CheckpointManager
from torch_port_util import port_hin


@pytest.fixture
def faults(monkeypatch):
    """Install an explicit fault plan (isolated from the environment)
    with near-zero backoff; always reset afterwards."""
    monkeypatch.setenv("PATHSIM_RETRY_BASE_DELAY", "0.001")
    yield inject.install_plan
    inject.reset()


@pytest.fixture
def preemption():
    yield preemption_handler
    preemption_handler.uninstall()
    preemption_handler.reset()


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn(120, 200, 12, seed=3)
    return jhin, port_hin(jhin)


@pytest.fixture(scope="module")
def clean_topk(graphs):
    """The JAX package's jax-sparse ranking (the reference) and the
    port's clean torch-sparse one, which must be equal."""
    jhin = graphs[0]
    want = JDriver(jcreate("jax-sparse", jhin, jcompile("APVPA", jhin.schema),
                           tile_rows=16)).rank_all(k=5)
    inject.install_plan("")
    try:
        got = _driver(graphs[1]).rank_all(k=5)
    finally:
        inject.reset()
    _same(got, want)
    return want


@pytest.fixture(scope="module")
def gexf_path(tmp_path_factory):
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin

    h = synthetic_hin(48, 80, 6, seed=7, materialize_ids=True)
    p = tmp_path_factory.mktemp("data") / "tiny.gexf"
    write_gexf(h, str(p))
    return str(p)


def _driver(hin):
    mp = compile_metapath("APVPA", hin.schema)
    return PathSimDriver(create_backend("torch-sparse", hin, mp,
                                        tile_rows=16, device="cpu"))


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.chaos
def test_load_seam_retries_and_succeeds(faults, gexf_path):
    inj = faults("gexf_load:error:1")
    h = load_dataset(gexf_path)
    assert h.type_size("author") == 48
    assert [e["seam"] for e in inj.events] == ["gexf_load"]


@pytest.mark.chaos
def test_partial_write_retried_and_atomic(faults, tmp_path):
    inj = faults("checkpoint_write:partial:1")
    ck = CheckpointManager(str(tmp_path / "ck"))
    arr = np.arange(12.0).reshape(3, 4)
    ck.save_unit("u0", vals=arr)
    assert [e["kind"] for e in inj.events] == ["partial"]
    np.testing.assert_array_equal(ck.load_unit("u0")["vals"], arr)
    leftovers = [p for p in (tmp_path / "ck").iterdir() if ".tmp" in p.name]
    assert leftovers == []


@pytest.mark.chaos
def test_midtile_crash_resume_is_exact_and_skips_done_units(
        faults, graphs, tmp_path, clean_topk):
    """Kill the run at tile 5 of 8, restart, and require the
    uninterrupted ranking and that the finished tiles are not
    recomputed."""
    ckdir = str(tmp_path / "ck")
    faults("tile_execute:crash:1@5")
    with pytest.raises(InjectedCrash):
        _driver(graphs[1]).rank_all(k=5, checkpoint_dir=ckdir)
    done_after_crash = CheckpointManager(ckdir).done_keys()
    assert len(done_after_crash) == 5

    inj = faults("")  # no faults now, but fires still count
    got = _driver(graphs[1]).rank_all(k=5, checkpoint_dir=ckdir)
    _same(got, clean_topk)
    assert inj.hits.get("tile_execute", 0) == 8 - len(done_after_crash)


@pytest.mark.chaos
def test_preemption_flushes_and_resumes_exactly(faults, preemption, graphs,
                                                tmp_path, clean_topk):
    ckdir = str(tmp_path / "ck")
    faults("tile_execute:preempt:1@2")
    with pytest.raises(Preempted) as exc_info:
        _driver(graphs[1]).rank_all(k=5, checkpoint_dir=ckdir)
    assert exc_info.value.resumable
    assert exc_info.value.checkpoint_dir == ckdir
    # everything dispatched before the preemption point is durable
    assert len(CheckpointManager(ckdir).done_keys()) >= 2

    preemption.reset()
    faults("")
    _same(_driver(graphs[1]).rank_all(k=5, checkpoint_dir=ckdir), clean_topk)


@pytest.mark.chaos
def test_full_run_with_a_fault_at_every_seam(faults, gexf_path, tmp_path):
    """One transient failure per seam: the run completes on the backend
    it asked for (retried, not degraded) with the clean ranking, and
    each recovery is logged."""
    def run(plan):
        inj = faults(plan)
        _, _, backend, driver = build(RunConfig(
            dataset=gexf_path, backend="torch-sparse", tile_rows=16,
            platform="cpu", echo=False))
        return inj, backend, driver.rank_all(
            k=5, checkpoint_dir=str(tmp_path / f"ck{len(plan)}"))

    _, _, clean = run("")
    inj, backend, got = run(
        "gexf_load:error:1,metapath_compile:error:1,backend_init:error:1,"
        "tile_execute:error:1,checkpoint_write:partial:1,"
        "device_execute:error:1")
    assert backend.name == "torch-sparse"  # retried, NOT degraded
    _same(got, clean)
    seams_hit = {e["seam"] for e in inj.events}
    assert {"gexf_load", "metapath_compile", "backend_init",
            "tile_execute", "checkpoint_write"} <= seams_hit
