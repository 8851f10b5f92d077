"""``torch-sharded`` against the JAX package's ``jax-sharded`` on the
CPU: D virtual shards of the host against D of the 8 virtual XLA devices
(tests/conftest.py), on a synthetic graph whose author count is a
multiple of no D but 1. Row sums, M, all-pairs (both strategies),
rank-all (both variants, the ring's K3 step as its plain version against
the Pallas step in interpret mode, and the folds), mid-ring resume after
a kill at any step, deltas, the exact-count guard, the degradation chain
and the CLI. Tolerance 0."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch.backends.base import (
    create_backend as tcreate,
)
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.resilience import inject
from torch_port_util import (
    delta_graphs,
    make_delta,
    metapaths,
    overflow_hins,
    port_hin,
    random_delta_spec,
    write_cli_gexf,
)


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn.synthetic_hin(203, 330, 11, seed=3)
    return jhin, port_hin(jhin)


def _pair(graphs, n_dev, **opts):
    jmp, tmp = metapaths(graphs)
    return (jcreate("jax-sharded", graphs[0], jmp, n_devices=n_dev, **opts),
            tcreate("torch-sharded", graphs[1], tmp, n_devices=n_dev,
                    device="cpu", **opts))


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_backend_matches_jax_sharded(graphs, n_dev):
    jb, tb = _pair(graphs, n_dev)
    assert tb.mesh.size == n_dev and tb.allpairs_strategy == "allgather"
    np.testing.assert_array_equal(tb.global_walks(), jb.global_walks())
    np.testing.assert_array_equal(tb.commuting_matrix(), jb.commuting_matrix())
    np.testing.assert_array_equal(tb.pairwise_rows([0, 5, 202]),
                                  jb.pairwise_rows([0, 5, 202]))
    for variant in ("rowsum", "diagonal"):
        _same(tb.topk(k=6, variant=variant), jb.topk(k=6, variant=variant))
        # the ring's K3 step (plain version) against the Pallas step
        _same(tb.topk_scores(k=6, variant=variant, use_kernel=True),
              jb.topk_scores(k=6, variant=variant, use_pallas=True))
    ring_j, ring_t = _pair(graphs, n_dev, allpairs_strategy="ring")
    for variant in ("rowsum", "diagonal"):
        np.testing.assert_array_equal(ring_t.all_pairs_scores(variant),
                                      jb.all_pairs_scores(variant))
    np.testing.assert_array_equal(ring_t.commuting_matrix(),
                                  ring_j.commuting_matrix())


@pytest.mark.chaos
def test_mid_ring_resume_after_a_kill_at_any_step(graphs, tmp_path):
    """A kill at ring step s (a non-retryable crash at the step's seam)
    leaves the snapshot of step s − 1; the resume runs steps s.. and
    returns the fused ring's arrays, and the JAX backend's resume on the
    same D. A directory from another shard count is refused."""
    jb, tb = _pair(graphs, 4)
    want = tb.topk(k=6)
    _same(want, jb.topk(k=6))
    for step in range(4):
        ckdir = tmp_path / f"kill{step}"
        inject.install_plan(f"tile_execute:crash:1@{step}")
        try:
            with pytest.raises(inject.InjectedCrash):
                tb.topk_scores(k=6, checkpoint_dir=str(ckdir))
        finally:
            inject.reset()
        from distributed_pathsim_tpu_torch.utils.checkpoint import (
            CheckpointManager,
        )

        keys = CheckpointManager(ckdir).done_keys()
        assert [k for k in keys if k.startswith("ring_")] == (
            [f"ring_bests_after_{step - 1}"] if step else [])
        _same(tb.topk_scores(k=6, checkpoint_dir=str(ckdir)), want)
    jdir = tmp_path / "jax"
    _same(jb.topk_scores(k=6, checkpoint_dir=str(jdir)), want)
    other = _pair(graphs, 2)[1]
    with pytest.raises(ValueError, match="different run"):
        other.topk_scores(k=6, checkpoint_dir=str(tmp_path / "kill1"))


def test_delta_patch_equals_rebuild_and_jax():
    """Deltas re-install the patched factor (limbs and caches dropped):
    equal to a rebuilt backend and to the patched JAX backend."""
    jhin, thin = delta_graphs()
    jmp, tmp = metapaths((jhin, thin))
    jb = jcreate("jax-sharded", jhin, jmp, n_devices=3)
    tb = tcreate("torch-sharded", thin, tmp, n_devices=3, device="cpu")
    tb.topk(k=5)
    rng = np.random.default_rng(11)
    for step in range(3):
        d = random_delta_spec(jhin, rng, n_changes=12, append=step == 1)
        jp = jdl.plan_delta(jhin, make_delta(jdl, d), jmp,
                            max_delta_fraction=0.5)
        tp = tdl.plan_delta(thin, make_delta(tdl, d), tmp,
                            max_delta_fraction=0.5)
        tb.check_delta(tp)
        jb.apply_delta(jp)
        tb.apply_delta(tp)
        assert tb._m is None and tb._rowsums is None and tb._limbs is None
        jhin, thin = jp.hin_new, tp.hin_new
        rebuilt = tcreate("torch-sharded", thin, tmp, n_devices=3,
                          device="cpu")
        for b in (rebuilt, jb):
            np.testing.assert_array_equal(tb.global_walks(), b.global_walks())
            _same(tb.topk(k=5), b.topk(k=5))
            _same(tb.topk_scores(k=5, use_kernel=True),
                  rebuilt.topk_scores(k=5, use_kernel=True))


def test_exact_count_guard_runs_before_anything_is_cached():
    """Counts past 2²⁴ refuse at construction, as the JAX backend does; a
    patched factor past the guard raises from check_delta and
    apply_delta with the backend as it was."""
    import types

    from distributed_pathsim_tpu_torch.ops import planner

    counts = np.zeros((6, 3), dtype=np.int64)
    counts[0, 0], counts[1:, 1] = 3000, 2  # row sums below 2^24
    jhin, thin = overflow_hins(counts)
    big = counts.copy()
    big[0, 0] = 5000  # 5000² passes 2^24
    bj, bt = overflow_hins(big)
    jmp, tmp = metapaths((bj, bt))
    with pytest.raises(OverflowError):
        jcreate("jax-sharded", bj, jmp, n_devices=2)
    with pytest.raises(OverflowError):
        tcreate("torch-sharded", bt, tmp, n_devices=2, device="cpu")
    tb = tcreate("torch-sharded", thin, metapaths((jhin, thin))[1],
                 n_devices=2, device="cpu")
    before, first = tb.topk(k=2), tb._first
    plan = types.SimpleNamespace(half_new=planner.fold_half(bt, tmp),
                                 hin_new=bt)
    with pytest.raises(OverflowError):
        tb.check_delta(plan)
    with pytest.raises(OverflowError):
        tb._apply_delta_impl(plan)
    assert tb.hin is thin and tb._first is first
    _same(tb.topk(k=2), before)


def test_degrade_chain_and_options():
    """torch-sharded steps down to torch on the host (and on to numpy),
    dropping the options only it takes."""
    from distributed_pathsim_tpu_torch import resilience

    assert resilience.backend_chain("torch-sharded", "cpu") == [
        "torch-sharded", "torch", "numpy"]
    assert resilience.backend_chain("torch-sharded", "cuda") == [
        "torch-sharded", "torch"]
    graphs = delta_graphs(headroom=0.0)
    tmp = metapaths(graphs)[1]
    inject.install_plan("backend_init:error:3")
    try:
        b = resilience.create_backend_resilient(
            "torch-sharded", graphs[1], tmp, n_devices=3,
            allpairs_strategy="ring", device="cpu")
    finally:
        inject.reset()
    assert b.name == "torch" and "n_devices" not in b.options


def test_cli_matches_torch_and_jax_sharded(tmp_path, capsys):
    """The batch CLI with --backend torch-sharded --n-devices 4: its log
    and ranking equal --backend torch's and the JAX CLI's jax-sharded run;
    a preemption at ring step 2 exits 75 and the rerun resumes to the
    same ranking."""
    from distributed_pathsim_tpu.cli import main as jax_main

    gexf = write_cli_gexf(tmp_path / "g.gexf")
    base = ["--dataset", gexf, "--platform", "cpu", "--quiet"]
    runs = {
        "torch": (torch_main, ["--backend", "torch"]),
        "sharded": (torch_main, ["--backend", "torch-sharded",
                                 "--n-devices", "4"]),
        "jax": (jax_main, ["--backend", "jax-sharded", "--n-devices", "4",
                           "--loader", "python"]),
    }
    logs, tsvs = {}, {}
    for name, (main, flags) in runs.items():
        log, tsv = tmp_path / f"{name}.log", tmp_path / f"{name}.tsv"
        assert main(base + flags + ["--source", "author_5", "--top-k", "6",
                                    "--output", str(log)]) == 0
        assert main(base + flags + ["--top-k", "7", "--ranking-out",
                                    str(tsv)]) == 0
        logs[name] = [ln for ln in log.read_text().splitlines()
                      if not ln.startswith("***")]
        tsvs[name] = tsv.read_bytes()
    assert logs["sharded"] == logs["torch"] == logs["jax"]
    assert tsvs["sharded"] == tsvs["torch"] == tsvs["jax"]
    sweep = base + runs["sharded"][1] + [
        "--top-k", "7", "--checkpoint-dir", str(tmp_path / "ck"),
        "--ranking-out", str(tmp_path / "resumed.tsv")]
    inject.install_plan("tile_execute:preempt:1@2")
    try:
        assert torch_main(sweep) == 75
    finally:
        inject.reset()
    assert "preempted" in capsys.readouterr().err
    assert torch_main(sweep) == 0
    assert (tmp_path / "resumed.tsv").read_bytes() == tsvs["torch"]


def test_ensemble_n_devices_cli(tmp_path, capsys):
    """--n-devices in multi-metapath mode shards the all-sources ranking;
    with a source it is refused, as in the JAX CLI."""
    from distributed_pathsim_tpu.cli import main as jax_main

    gexf = write_cli_gexf(tmp_path / "g.gexf")
    argv = ["--dataset", gexf, "--platform", "cpu", "--metapath",
            "APVPA,APA", "--weights", "0.6,0.4", "--top-k", "5",
            "--n-devices", "3"]
    capsys.readouterr()
    assert torch_main(argv) == 0
    out_t = capsys.readouterr().out
    assert jax_main(argv + ["--loader", "python"]) == 0
    out_j = capsys.readouterr().out
    assert "sharded over 3 devices" in out_t
    assert out_t.replace("torch", "jax") == out_j.replace("torch", "jax")
    assert torch_main(argv + ["--source", "author_5"]) == 1
    assert "applies to the all-sources ranking" in capsys.readouterr().err
