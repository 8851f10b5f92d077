"""Port parity: the learned serving lane (learned/, the service's learned
lane) against the JAX package's on the CPU — twins of
tests/test_learned.py's serving tests, with both services booted from
the SAME towers, written by the JAX package's trainer to a temporary
checkpoint (the two packages draw different random numbers, so parity
goes through the checkpoint, never through training).

``learned_cand_mult=32`` on the 120-author fixture makes every candidate
set hold every other row: coverage is total, so every learned answer
must be bit-identical to the exact one and to the JAX service's, row
for row:

- every eligible row, and ``stats()["learned"]`` equal across packages;
- the fallbacks counted as the JAX service counts them: ``degenerate``,
  ``no_towers``, ``metapath``, ``stale``, ``low_confidence``, and the
  cascade learned → ann → exact;
- the cold-start append answered bit-identically before and after
  ``refresh_towers``, by hand and by the background refresh;
- a checkpoint the service cannot use: refused quietly where the arm is
  optional, and under learned mode replaced by towers the service
  distills itself, as the JAX service does;
- the ``refresh_towers`` op and ``"mode": "learned"`` through the port's
  ``serve_loop`` against the JAX one.
"""

import io
import json
import time

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdelta
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.learned import save_towers as jsave
from distributed_pathsim_tpu.learned import train_towers as jtrain
from distributed_pathsim_tpu.obs.metrics import get_registry as jregistry
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.serving.cache import (
    graph_fingerprint as jfingerprint,
)
from distributed_pathsim_tpu.serving.protocol import serve_loop as jloop
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdelta
from distributed_pathsim_tpu_torch.obs.metrics import get_registry
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import serve_loop
from torch_port_util import port_hin

REASONS = ("no_towers", "stale", "uncovered", "degenerate",
           "low_confidence", "metapath")


@pytest.fixture(autouse=True)
def untuned():
    """Both packages untuned (the checked-in CPU table is fingerprinted
    for another jax), so every knob resolves to its default whatever
    file ran before this one in the worker."""
    prev_j, prev_t = jtuning._state.enabled, tuning.dispatch._state.enabled
    jtuning.set_enabled(False)
    tuning.set_enabled(False)
    yield
    jtuning.set_enabled(prev_j)
    tuning.set_enabled(prev_t)


@pytest.fixture(scope="module")
def graphs():
    # tests/test_learned.py's fixture graph, headroom so deltas append
    base = jsyn(120, 200, 8, seed=7)
    return (jdelta.with_headroom(base, 0.25),
            tdelta.with_headroom(port_hin(base), 0.25))


@pytest.fixture(scope="module")
def towers(graphs, tmp_path_factory):
    """Towers the JAX package trained for the fixture graph, keyed to
    its token at delta_seq 0."""
    jhin = graphs[0]
    path = str(tmp_path_factory.mktemp("towers") / "towers.npz")
    jtrain(jhin, "APVPA", dim=16, hidden=32, steps=40, hard_sources=48,
           hard_k=8, token=(jfingerprint(jhin), 0), out=path)
    return path


def _services(graphs, towers, exact_only=False, **cfg):
    jhin, thin = graphs
    cfg.setdefault("max_wait_ms", 0.5)
    cfg.setdefault("warm", False)
    cfg.setdefault("compact_auto", False)
    if not exact_only:
        cfg.setdefault("topk_mode", "learned")
        cfg.setdefault("learned_checkpoint", towers)
        cfg.setdefault("learned_shadow_every", 0)
        cfg.setdefault("learned_auto_refresh", False)
        cfg.setdefault("learned_cand_mult", 32)
    js = JService(jcreate("numpy", jhin, jcompile("APVPA", jhin.schema)),
                  config=JConfig(**cfg))
    ts = PathSimService(
        create_backend("torch", thin, compile_metapath("APVPA", thin.schema),
                       device="cpu"),
        config=ServeConfig(**cfg))
    return js, ts


def _fallbacks():
    """(JAX, port) learned fallback counters by reason."""
    out = []
    for reg in (jregistry(), get_registry()):
        fam = reg.counter(
            "dpathsim_learned_fallbacks_total",
            "learned-requested queries degraded to ann/exact, by reason")
        out.append({r: fam.labels(reason=r).value for r in REASONS})
    return out


def _moved(before):
    return [{r: a[r] - b[r] for r in REASONS}
            for b, a in zip(before, _fallbacks())]


def _same(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _eligible(svc):
    return np.flatnonzero(np.asarray(svc._learned.d)[: svc.n] > 0)


def test_learned_answers_bit_identical_to_jax_and_exact(graphs, towers):
    js, ts = _services(graphs, towers)
    try:
        assert ts.stats()["learned"] == js.stats()["learned"]
        assert ts.stats()["learned"]["enabled"]
        assert ts._learned.device.type == "cpu"
        np.testing.assert_allclose(ts._learned._emb.numpy(),
                                   js._learned._emb, rtol=1e-6, atol=1e-6)
        through = ts._learned._m_requests.value
        rows = _eligible(ts)
        assert rows.size > 60
        for row in rows:
            got = ts.topk_index(int(row), k=7, mode="learned")
            assert _same(got, js.topk_index(int(row), k=7, mode="learned"))
            assert _same(got, ts.topk_index(int(row), k=7, mode="exact"))
        assert ts._learned._m_requests.value - through == rows.size
        # the learned tier of the result cache: a repeat is its hit, a
        # key of its own (never an exact or ann answer), and invalidate
        # clears it
        key = ts._learned_key(int(rows[0]), 7)
        assert key[4:] == ("learned", 16, 32, int(rows[0]), 7)
        assert ts.result_cache.get(key) is not None
        ts.topk_index(int(rows[0]), k=7, mode="learned")
        assert ts._learned._m_requests.value - through == rows.size
        ts.invalidate()
        assert len(ts.result_cache) == 0
        ts.topk_index(int(rows[0]), k=7, mode="learned")
        assert ts._learned._m_requests.value - through == rows.size + 1
        assert ts.stats()["learned"] == js.stats()["learned"]
    finally:
        js.close()
        ts.close()


def test_degenerate_and_no_towers_fall_back_as_jax(graphs, towers):
    js, ts = _services(graphs, towers)
    try:
        dead = np.flatnonzero(np.asarray(ts._learned.d)[: ts.n] <= 0)
        assert dead.size, "fixture graph needs a zero-denominator row"
        row = int(dead[0])
        assert ts.learned_fallback_reason(row, "learned") == "degenerate"
        assert js.learned_fallback_reason(row, "learned") == "degenerate"
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(row, k=5, mode="learned")
            assert _same(got, svc.topk_index(row, k=5, mode="exact"))
        jd, td = _moved(before)
        assert td == jd and td["degenerate"] == 1
    finally:
        js.close()
        ts.close()
    js, ts = _services(graphs, towers, exact_only=True)
    try:
        assert ts.stats()["learned"] is None and ts._learned is None
        assert ts.health()["modes"]["learned"] is None
        assert ts.learned_fallback_reason(3, "learned") == "no_towers"
        assert ts.learned_fallback_reason(3) is None  # exact by default
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(3, k=5, mode="learned")
            assert _same(got, svc.topk_index(3, k=5, mode="exact"))
        jd, td = _moved(before)
        assert td == jd and td["no_towers"] == 1
    finally:
        js.close()
        ts.close()


def test_secondary_metapath_and_ann_cascade_counted_as_jax(graphs, towers,
                                                          tmp_path):
    """Towers embed ONE metapath: a learned query naming another degrades
    (counted ``metapath``) to that engine's exact answer. With an ANN
    index beside the towers, an ineligible row degrades learned → ann →
    exact, each arm counting its own fallback."""
    js, ts = _services(graphs, towers)
    try:
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(2, k=5, mode="learned", metapath="APA")
            assert _same(got, svc.topk_index(2, k=5, mode="exact",
                                             metapath="APA"))
        jd, td = _moved(before)
        assert td == jd and td["metapath"] == 1
        assert ts.learned_fallback_reason(2, "learned",
                                          metapath="APA") == "metapath"
    finally:
        js.close()
        ts.close()
    # an index artifact beside the towers (the JAX build: the format is
    # shared), both arms in one service
    from distributed_pathsim_tpu.index import build_index as jbuild

    jhin = graphs[0]
    art = str(tmp_path / "index.npz")
    jbuild(hin=jhin, metapath=jcompile("APVPA", jhin.schema),
           token=(jfingerprint(jhin), 0)).save(art)
    js, ts = _services(graphs, towers, index_path=art, ann_shadow_every=0)
    try:
        assert ts._ann is not None and ts._learned is not None
        dead = int(np.flatnonzero(np.asarray(ts._learned.d)[: ts.n] <= 0)[0])
        reg = (jregistry(), get_registry())
        ann_fam = [r.counter("dpathsim_ann_fallbacks_total",
                             "ann-requested queries answered exactly "
                             "instead, by reason") for r in reg]
        ann0 = [f.labels(reason="degenerate").value for f in ann_fam]
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(dead, k=5)
            assert _same(got, svc.topk_index(dead, k=5, mode="exact"))
        jd, td = _moved(before)
        assert td == jd and td["degenerate"] == 1
        ann1 = [f.labels(reason="degenerate").value for f in ann_fam]
        assert ann1[0] - ann0[0] == ann1[1] - ann0[1] == 1
        row = int(_eligible(ts)[5])
        assert _same(ts.topk_index(row, k=5), js.topk_index(row, k=5))
    finally:
        js.close()
        ts.close()


def test_shadow_gate_trips_and_refresh_resets(graphs, towers):
    js, ts = _services(graphs, towers, learned_shadow_every=1,
                       learned_min_shadow=2, learned_recall_floor=1.01)
    try:
        rows = _eligible(ts)[:6]
        for svc in (js, ts):
            for row in rows:
                svc.topk_index(int(row), k=5, mode="learned")
        # how many samples land before the gate shuts depends on the
        # completion thread's timing (shadows run after the futures
        # resolve), in both packages: compare the rest
        snap, jsnap = ts.stats()["learned"], js.stats()["learned"]
        assert snap["shadow_samples"] >= 2 and jsnap["shadow_samples"] >= 2
        del snap["shadow_samples"], jsnap["shadow_samples"]
        assert snap == jsnap
        assert not snap["enabled"]
        row = int(rows[0])
        assert ts.learned_fallback_reason(row, "learned") == "low_confidence"
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(row, k=5, mode="learned")
            assert _same(got, svc.topk_index(row, k=5, mode="exact"))
        jd, td = _moved(before)
        assert td == jd and td["low_confidence"] == 1
        rj, rt = js.refresh_towers(), ts.refresh_towers()
        assert {k: v for k, v in rt.items() if k != "ms"} == {
            k: v for k, v in rj.items() if k != "ms"}
        assert ts.learned_fallback_reason(row, "learned") is None
        assert ts.stats()["learned"]["enabled"]
    finally:
        js.close()
        ts.close()


def _append_author(svc, hin):
    """tests/test_learned.py's cold-start delta: one never-seen author
    appended and wired to 5 papers, in one batch."""
    n0 = svc.n
    rng = np.random.default_rng(3)
    papers = sorted({int(p) for p in rng.integers(0, hin.type_size("paper"),
                                                  5)})
    return n0, (dict(node_type="author", count=1),
                dict(add=[[n0, p] for p in papers]))


def _cold_delta(dl, nodes, edges):
    return dl.DeltaBatch(nodes=(dl.NodeAppend(**nodes),),
                         edges=(dl.edge_delta("author_of", **edges),))


def test_cold_start_appended_author_end_to_end(graphs, towers):
    js, ts = _services(graphs, towers)
    try:
        n0, (nodes, edges) = _append_author(ts, graphs[1])
        ij = js.update(_cold_delta(jdelta, nodes, edges))
        it = ts.update(_cold_delta(tdelta, nodes, edges))
        assert it["mode"] == ij["mode"] == "delta"
        for key in ("learned_pending_appends", "learned_stale_rows",
                    "affected_rows", "fingerprint"):
            assert it[key] == ij[key], key
        assert it["learned_pending_appends"] == 1
        assert ts.stats()["learned"] == js.stats()["learned"]
        assert ts.stats()["learned"]["cold_start_ratio"] == 0.0
        assert ts.health()["modes"]["learned"] == js.health()["modes"][
            "learned"]
        # before any refresh: exact through the counted 'stale' fallback
        assert ts.learned_fallback_reason(n0, "learned") == "stale"
        before = _fallbacks()
        exact = ts.topk_index(n0, k=6, mode="exact")
        for svc in (js, ts):
            assert _same(svc.topk_index(n0, k=6, mode="learned"), exact)
        jd, td = _moved(before)
        assert td == jd and td["stale"] == 1
        assert np.isfinite(exact[0]).any()
        # one O(Δ) absorb re-embeds the stale and appended rows only
        rj, rt = js.refresh_towers(), ts.refresh_towers()
        assert {k: v for k, v in rt.items() if k != "ms"} == {
            k: v for k, v in rj.items() if k != "ms"}
        assert rt["appended"] == 1 and rt["stale_remaining"] == 0
        assert rt["refreshed"] >= it["learned_stale_rows"]
        assert rt["token"] == list(ts.consistency_token)
        np.testing.assert_allclose(ts._learned._emb.numpy(),
                                   js._learned._emb, rtol=1e-6, atol=1e-6)
        # after: through the towers, the same bytes
        assert ts.learned_fallback_reason(n0, "learned") is None
        through = ts._learned._m_requests.value
        for svc in (js, ts):
            assert _same(svc.topk_index(n0, k=6, mode="learned"), exact)
        assert ts._learned._m_requests.value == through + 1
        snap = ts.stats()["learned"]
        assert snap == js.stats()["learned"]
        assert (snap["pending_appends"], snap["cold_start_ratio"],
                snap["appended_seen"]) == (0, 1.0, 1)
        for row in _eligible(ts)[::7]:
            assert _same(ts.topk_index(int(row), k=5, mode="learned"),
                         ts.topk_index(int(row), k=5, mode="exact"))
    finally:
        js.close()
        ts.close()


def test_background_refresh_after_a_delta(graphs, towers):
    """With auto-refresh on (cadence 1 untuned), the delta schedules the
    absorb on a background thread: stale and pending drain to 0 and the
    appended author answers through the towers, as in the JAX service."""
    js, ts = _services(graphs, towers, learned_auto_refresh=True)
    try:
        n0, (nodes, edges) = _append_author(ts, graphs[1])
        js.update(_cold_delta(jdelta, nodes, edges))
        ts.update(_cold_delta(tdelta, nodes, edges))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                ts._learned_refresh_inflight or js._learned_refresh_inflight):
            time.sleep(0.05)
        snap = ts.stats()["learned"]
        assert snap == js.stats()["learned"]
        assert (snap["stale_rows"], snap["pending_appends"]) == (0, 0)
        assert snap["token"] == list(ts.consistency_token)
        assert ts.learned_fallback_reason(n0, "learned") is None
        assert _same(ts.topk_index(n0, k=6, mode="learned"),
                     js.topk_index(n0, k=6, mode="learned"))
    finally:
        js.close()
        ts.close()


def test_unusable_checkpoints_refused(graphs, towers, tmp_path):
    """A checkpoint keyed to another graph or token: refused quietly where
    the learned arm is optional (``learned_towers_rejected``; JAX too);
    under learned mode the service distills its own towers instead, as
    the JAX service does — and so it does with no checkpoint at all:
    towers keyed to the service's token, answers bit-identical to the
    exact lane's."""
    from distributed_pathsim_tpu.learned import load_towers as jload

    enc, _ = jload(towers)
    foreign = str(tmp_path / "foreign.npz")
    jsave(foreign, enc, ("0123456789abcdef", 0))
    lagging = str(tmp_path / "lagging.npz")
    jsave(lagging, enc, (jfingerprint(graphs[0]), 3))
    thin = graphs[1]
    backend = create_backend("torch", thin,
                             compile_metapath("APVPA", thin.schema),
                             device="cpu")
    for path in (foreign, lagging, str(tmp_path / "missing.npz"), None):
        if path is not None:
            svc = PathSimService(backend, config=ServeConfig(
                warm=False, learned_checkpoint=path))
            try:
                assert svc.stats()["learned"] is None
                assert svc.learned_fallback_reason(1, "learned") == \
                    "no_towers"
            finally:
                svc.close()
        svc = PathSimService(backend, config=ServeConfig(
            warm=False, topk_mode="learned", learned_checkpoint=path,
            learned_steps=10, learned_cand_mult=32,
            learned_shadow_every=0))
        try:
            snap = svc.stats()["learned"]
            assert snap is not None and snap["enabled"], path
            assert snap["token"] == list(svc.consistency_token)
            assert svc._learned.encoder.meta == {"steps": 10, "seed": 0}
            assert _same(svc.topk_index(4, k=5, mode="learned"),
                         svc.topk_index(4, k=5, mode="exact")), path
        finally:
            svc.close()
    # the optional arm on an exact service: loaded, and learned queries
    # answer through it while exact stays the default
    svc = PathSimService(backend, config=ServeConfig(
        warm=False, learned_checkpoint=towers, learned_cand_mult=32))
    try:
        assert svc.stats()["learned"]["enabled"]
        assert _same(svc.topk_index(4, k=5, mode="learned"),
                     svc.topk_index(4, k=5))
        # towers whose feature width no longer fits: refresh_towers
        # reports it (JAX too) and moves nothing
        import dataclasses

        lr = svc._learned
        (w0, b0), *rest = lr.encoder.layers
        lr.encoder = dataclasses.replace(lr.encoder,
                                         layers=[(w0[1:], b0), *rest])
        lr.mark_stale(np.asarray([4]))
        res = svc.refresh_towers()
        assert (res["refreshed"], res["stale_remaining"]) == (0, 1)
        assert "retrain" in res["unsupported"]
        assert svc.learned_fallback_reason(4, "learned") == "stale"
    finally:
        svc.close()


def test_jsonl_learned_mode_and_refresh_towers_match_jax(graphs, towers):
    js, ts = _services(graphs, towers)
    try:
        # an edge delta (the fixture's authors carry implicit ids, so the
        # wire appends none): row 5's new papers stale it and its
        # neighbours until refresh_towers
        blk = graphs[1].blocks["author_of"]
        have = set(blk.cols[blk.rows == 5].tolist())
        new = [p for p in range(40) if p not in have][:2]
        script = [
            {"id": 1, "op": "topk", "row": 5, "k": 4, "mode": "learned"},
            {"id": 2, "op": "update",
             "add_edges": [{"rel": "author_of", "src_row": 5, "dst_row": p}
                           for p in new],
             "want_rows": True},
            {"id": 3, "op": "topk", "row": 5, "k": 4, "mode": "learned"},
            {"id": 4, "op": "refresh_towers"},
            {"id": 5, "op": "topk", "row": 5, "k": 4, "mode": "learned"},
            {"id": 6, "op": "topk", "row": 5, "k": 4},
            {"id": 7, "op": "health"},
            {"id": 8, "op": "stats"},
            {"id": 9, "op": "topk", "row": 5, "mode": "bogus"},
        ]
        outs = []
        for loop, svc in ((jloop, js), (serve_loop, ts)):
            buf = io.StringIO()
            text = "\n".join(json.dumps(r) for r in script) + "\n"
            assert loop(svc, io.StringIO(text), buf) == 0
            outs.append([json.loads(x) for x in buf.getvalue().splitlines()])
        jr, tr = outs
        assert [r["ok"] for r in tr] == [r["ok"] for r in jr] == [
            True] * 8 + [False]
        for i in (0, 2, 4, 5):
            assert tr[i]["result"] == jr[i]["result"], script[i]
        assert tr[2]["result"] == tr[4]["result"]
        assert {k: v for k, v in tr[3]["result"].items() if k != "ms"} == {
            k: v for k, v in jr[3]["result"].items() if k != "ms"}
        assert 5 in tr[1]["result"]["affected_row_list"]
        assert tr[1]["result"]["learned_stale_rows"] == len(
            tr[1]["result"]["affected_row_list"])
        assert tr[3]["result"]["refreshed"] == tr[1]["result"][
            "learned_stale_rows"]
        assert tr[3]["result"]["stale_remaining"] == 0
        assert tr[6]["result"]["modes"]["learned"] == jr[6]["result"][
            "modes"]["learned"]
        assert tr[7]["result"]["learned"] == jr[7]["result"]["learned"]
        assert "unknown topk mode" in tr[8]["error"]
    finally:
        js.close()
        ts.close()
