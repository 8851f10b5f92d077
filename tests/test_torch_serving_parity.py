"""Port parity: the port's PathSimService against the JAX package's, on
the CPU, same graph. Every row at k = 1, 5, 10, ``scores_index``, and
three successive ``update``s (two patches, with a node append, then a
headroom overflow that rebuilds): mode, affected-row count, chained
fingerprint and every answer after each, bit for bit (values and tie
order). The JAX side is built as ``serve --no-tuning`` with compaction
off, the configuration the port mirrors; services are fresh per test."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from torch_port_util import delta_graphs, make_delta, random_delta_spec

OPTS = {"torch": {"device": "cpu"}, "torch-sparse": {"device": "cpu"},
        "numpy": {}}


@pytest.fixture
def no_tuning():
    """The JAX service without a tuning table (restored afterwards: the
    switch is process-wide)."""
    prev = jtuning._state.enabled
    jtuning.set_enabled(False)
    try:
        yield
    finally:
        jtuning.set_enabled(prev)


def _services(jhin, thin, port_backend="torch", **cfg):
    cfg.setdefault("max_batch", 8)
    cfg.setdefault("max_wait_ms", 1.0)
    jb = jcreate("jax", jhin, jmeta.compile_metapath("APVPA", jhin.schema))
    tb = create_backend(port_backend, thin,
                        compile_metapath("APVPA", thin.schema),
                        **OPTS[port_backend])
    return (JService(jb, config=JConfig(compact_auto=False, **cfg)),
            PathSimService(tb, config=ServeConfig(compact_auto=False,
                                                  **cfg)))


def _assert_answers_equal(js, ts, k, rows):
    jf = [js.submit_topk(int(r), k) for r in rows]
    tf = [ts.submit_topk(int(r), k) for r in rows]
    for r, a, b in zip(rows, jf, tf):
        jv, ji = a.result(timeout=60)
        tv, ti = b.result(timeout=60)
        np.testing.assert_array_equal(tv, jv, err_msg=f"row {r}")
        np.testing.assert_array_equal(ti, ji, err_msg=f"row {r}")


@pytest.mark.parametrize("k", [1, 5, 10])
def test_every_row_matches_jax_service(no_tuning, k):
    jhin, thin = delta_graphs(n_authors=160, n_papers=260, n_venues=9,
                              seed=7)
    js, ts = _services(jhin, thin, warm=False)
    try:
        _assert_answers_equal(js, ts, k, np.arange(ts.n))
        assert ts.consistency_token == js.consistency_token
        assert ts.stats()["dispatch"]["requests"] == ts.n
    finally:
        js.close()
        ts.close()


def test_scores_index_matches_jax_service(no_tuning):
    jhin, thin = delta_graphs()
    js, ts = _services(jhin, thin, warm=False)
    try:
        for r in (0, 17, 95):
            np.testing.assert_array_equal(ts.scores_index(r),
                                          js.scores_index(r))
            # a second read is a tile-cache hit and a copy of it
            got = ts.scores_index(r)
            got[:] = -1.0
            np.testing.assert_array_equal(ts.scores_index(r),
                                          js.scores_index(r))
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("port_backend", ["torch", "torch-sparse", "numpy"])
def test_three_updates_match_jax_service(no_tuning, port_backend):
    jhin, thin = delta_graphs(headroom=0.05, n_authors=96)
    js, ts = _services(jhin, thin, port_backend)
    try:
        rows = np.arange(ts.n)
        _assert_answers_equal(js, ts, 5, rows)  # fill both caches
        rng = np.random.default_rng(3)
        n0 = ts.n
        for step in range(3):
            if step < 2:
                spec = random_delta_spec(js.hin, rng, n_changes=10,
                                         append=step == 1)
            else:  # past the 8-slot reserve: the rebuild fallback
                spec = {"edges": [], "nodes": [
                    ("author", tuple(f"new_{i}" for i in range(12)))]}
            jr = js.update(make_delta(jdl, spec), want_rows=True)
            tr = ts.update(make_delta(tdl, spec), want_rows=True)
            for key in ("mode", "reason", "edge_changes", "node_appends",
                        "affected_rows", "purged_entries", "delta_seq",
                        "base_fp", "fingerprint", "n", "affected_row_list"):
                assert tr[key] == jr[key], (step, key)
            assert tr["mode"] == ("delta" if step < 2 else "rebuild")
            assert ts.consistency_token == js.consistency_token
            rows = np.arange(ts.n)
            _assert_answers_equal(js, ts, 5, rows)
            np.testing.assert_array_equal(ts.scores_index(3),
                                          js.scores_index(3))
        assert ts.n == n0 + 1 + 12
        assert ts.stats()["delta"]["deltas"] == 2
        assert ts.stats()["delta"]["rebuilds"] == 1
    finally:
        js.close()
        ts.close()
