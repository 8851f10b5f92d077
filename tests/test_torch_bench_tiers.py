"""The port's ann and learned load generators (``distributed_pathsim_
tpu_torch.bench_serving``) on the CPU, held against the repository's
harness (``bench_serving.py``) on the JAX package.

- The ann smoke's checks at the harness's smoke arguments (none is the
  clock's).
- ``run_ann_bench`` at 256 authors through both harnesses on one seed:
  equal key trees and an equal ``recall`` block (the index builds on
  the host from the same arrays, the rerank is exact f64).
- The learned bench at the smoke's arguments on the port's own
  distillation: every check but ``recall_ge_0_99``, which the twin
  computes as the harness does and a run is not held to (the packages
  draw different initial tower weights; ``CARD_EXEMPT_CHECKS``).
- The same towers: a checkpoint the JAX package distilled on the smoke
  graph, loaded by a learned service of each package, gives the twin's
  ``_ann_recall_audit`` equal to the harness's on the same rows,
  ``recall_at_k`` included.
"""

import numpy as np
import pytest

from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.learned import save_towers as jsave
from distributed_pathsim_tpu.learned import train_towers as jtrain
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu.serving.cache import (
    graph_fingerprint as jfingerprint,
)
from distributed_pathsim_tpu_torch import bench_serving as bs
from torch_port_util import (  # noqa: F401  (untuned: an autouse fixture)
    assert_deterministic,
    jax_harness,
    key_tree,
    port_hin,
    untuned,
)

SMALL_ANN = dict(n_authors=256, n_papers=448, n_venues=10, clients=2,
                 queries_per_client=4, max_batch=8, max_wait_ms=1.0, reps=1,
                 k=10, oracle_samples=24)


def test_ann_smoke_checks():
    result = bs.run_ann_bench(**bs.ANN_SMOKE, platform="cpu")
    checks = bs.ann_checks(result)
    assert_deterministic(checks, "ann")
    assert all(checks.values()), checks
    assert result["staleness_exercise"]["stale_rows_after_update"] > 0


def test_run_ann_bench_matches_the_jax_harness():
    want = jax_harness().run_ann_bench(**SMALL_ANN, backend="jax")
    got = bs.run_ann_bench(**SMALL_ANN, platform="cpu")
    leaves = ("buckets", "speedups")
    assert key_tree(got, leaves=leaves) == key_tree(want, leaves=leaves)
    assert got["recall"] == want["recall"]
    assert got["load"] == want["load"]
    assert set(got["arms"]) == set(want["arms"])
    assert got["staleness_exercise"]["stale_row_answered_exactly"]


def test_learned_bench_checks_but_the_recall_gate():
    result = bs.run_learned_bench(**bs.LEARNED_SMOKE, platform="cpu")
    checks = bs.learned_checks(result)
    assert_deterministic(checks, "learned",
                         exempt=bs.CARD_EXEMPT_CHECKS["learned"])
    assert result["learned_state"] is not None
    assert result["cold_start"]["refresh"]["appended"] == 1
    assert 0.0 < result["recall"]["recall_at_k"] <= 1.0


@pytest.fixture(scope="module")
def smoke_towers(tmp_path_factory):
    """Towers the JAX package distilled on the learned smoke's graph,
    keyed to its token at delta_seq 0, and that graph."""
    cfg = bs.LEARNED_SMOKE
    jhin = jsyn(cfg["n_authors"], cfg["n_papers"], cfg["n_venues"], seed=0)
    token = (jfingerprint(jhin), 0)
    enc, _ = jtrain(jhin, jcompile("APVPA", jhin.schema), steps=40,
                    hard_sources=64, hard_k=16, token=token)
    path = str(tmp_path_factory.mktemp("towers") / "towers.npz")
    jsave(path, enc, token)
    return jhin, path


def test_same_towers_recall_audit_matches_the_jax_harness(smoke_towers):
    jhin, towers = smoke_towers
    jb = jax_harness()
    cfg = dict(max_batch=8, max_wait_ms=1.0, caches=False, k=10)
    learned = dict(topk_mode="learned", learned_checkpoint=towers,
                   learned_shadow_every=0, learned_auto_refresh=False,
                   learned_cand_mult=bs.LEARNED_SMOKE["learned_cand_mult"])
    thin = port_hin(jhin)
    services = [
        jb._build_service(jhin, "numpy", **cfg),
        jb._build_service(jhin, "numpy", **cfg, **learned),
        bs._build_service(thin, "torch", **cfg, platform="cpu"),
        bs._build_service(thin, "torch", **cfg, platform="cpu", **learned),
    ]
    try:
        j_exact, j_lrn, t_exact, t_lrn = services
        # both loaded the checkpoint's towers (a refused one would be
        # replaced by towers distilled at 200 steps)
        assert j_lrn._learned.encoder.meta["steps"] == 40
        assert t_lrn._learned.encoder.meta["steps"] == 40
        rows = np.random.default_rng(0).choice(
            np.flatnonzero(t_lrn._d > 0), size=48, replace=False)
        want = jb._ann_recall_audit(j_lrn, j_exact, rows, 10,
                                    mode="learned")
        got = bs._ann_recall_audit(t_lrn, t_exact, rows, 10,
                                   mode="learned")
    finally:
        for svc in services:
            svc.close()
    assert got == want
    assert got["recall_at_k"] < 1.0  # the audit saw uncovered rows
