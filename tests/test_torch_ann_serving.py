"""Port parity: the ANN serving lane (serving/ann.py, the service's ann
lane) against the JAX package's on the CPU — twins of
tests/test_index.py's serving tests.

- a port and a JAX ``topk_mode="ann"`` service on one graph answer the
  same rows identically, both probe variants, with equal ``stats()["ann"]``;
- an ANN answer whose index set equals the exact answer's is
  bit-identical to it (values and order), both variants;
- recall@10 ≥ 0.99 at 2048 authors with the default knobs;
- staleness after an update answers exactly, ``refresh_index`` moves the
  index epoch to the service's token, the fallback counts equal the
  JAX service's; ``no_index`` and the shadow gate's ``low_confidence``;
- the ``refresh_index`` op and ``"mode": "ann"`` through the port's
  ``serve_loop`` against the JAX one, ``health``'s ANN epoch and
  ``stats()["ann"]``;
- ANN answers unchanged across a forced compaction.
"""

import io
import json

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdelta
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.obs.metrics import get_registry as jregistry
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.serving.protocol import serve_loop as jloop
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdelta
from distributed_pathsim_tpu_torch.index.build import (
    half_chain_and_denominators,
)
from distributed_pathsim_tpu_torch.obs.metrics import get_registry
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import serve_loop
from torch_port_util import port_hin

FALLBACKS = ("stale", "uncovered", "degenerate", "low_confidence",
             "no_index")


@pytest.fixture(autouse=True)
def untuned():
    """Both packages untuned (the checked-in CPU table is fingerprinted
    for another jax), so the knobs resolve to their defaults."""
    prev = jtuning._state.enabled
    jtuning.set_enabled(False)
    yield
    jtuning.set_enabled(prev)


def _graphs(n_authors=300, n_papers=520, n_venues=12, seed=7,
            headroom=None):
    jhin = jsyn(n_authors, n_papers, n_venues, seed=seed,
                materialize_ids=True)
    thin = port_hin(jhin)
    if headroom:
        jhin = jdelta.with_headroom(jhin, headroom)
        thin = tdelta.with_headroom(thin, headroom)
    return jhin, thin


def _services(jhin, thin, **cfg):
    cfg.setdefault("max_wait_ms", 0.5)
    cfg.setdefault("warm", False)
    cfg.setdefault("topk_mode", "ann")
    cfg.setdefault("ann_shadow_every", 0)
    cfg.setdefault("compact_auto", False)
    js = JService(jcreate("numpy", jhin, jcompile("APVPA", jhin.schema)),
                  config=JConfig(**cfg))
    ts = PathSimService(
        create_backend("torch", thin, compile_metapath("APVPA", thin.schema),
                       device="cpu"),
        config=ServeConfig(**cfg))
    return js, ts


def _fallbacks():
    """(JAX, port) fallback counters by reason."""
    out = []
    for reg in (jregistry(), get_registry()):
        fam = reg.counter(
            "dpathsim_ann_fallbacks_total",
            "ann-requested queries answered exactly instead, by reason")
        out.append({r: fam.labels(reason=r).value for r in FALLBACKS})
    return out


def _delta_counts(before, after):
    return [{r: a[r] - b[r] for r in FALLBACKS}
            for b, a in zip(before, after)]


def _same(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("variant", ["rerank-all", "shortlist"])
def test_ann_services_answer_as_jax(variant):
    js, ts = _services(*_graphs(), ann_variant=variant)
    try:
        assert ts._ann.variant == variant
        assert ts._ann.route_on_host == (variant == "rerank-all")
        rows = np.random.default_rng(5).choice(300, 32, replace=False)
        for row in rows:
            got = ts.topk_index(int(row), k=10)
            assert _same(got, js.topk_index(int(row), k=10)), row
            assert got[1].dtype == np.int64 and got[0].dtype == np.float64
        assert ts.stats()["ann"] == js.stats()["ann"]
        assert ts.stats()["topk_mode"] == "ann"
    finally:
        js.close()
        ts.close()


@pytest.mark.parametrize("variant", ["rerank-all", "shortlist"])
def test_ann_bit_identical_when_covered(variant):
    """Whenever the ann answer's index set equals the exact answer's,
    the two are bit-identical (values AND order)."""
    jhin, thin = _graphs()
    _, ts = _services(jhin, thin, ann_variant=variant)
    try:
        c, d = half_chain_and_denominators(
            thin, compile_metapath("APVPA", thin.schema))
        eligible = np.flatnonzero(d > 0)
        covered = 0
        for row in np.random.default_rng(5).choice(eligible, 32,
                                                   replace=False):
            av, ai = ts.topk_index(int(row), k=10, mode="ann")
            ev, ei = ts.topk_index(int(row), k=10, mode="exact")
            if set(ai.tolist()) == set(ei.tolist()):
                covered += 1
                assert np.array_equal(av, ev) and np.array_equal(ai, ei)
        assert covered > 0  # the assertion must have bitten
    finally:
        ts.close()


def test_recall_gate_2048_default_knobs():
    """recall@10 ≥ 0.99 at 2048 authors with the shipped default knobs
    (score recall; the strict id recall ≥ 0.97)."""
    jhin = jsyn(2048, 4096, 48, seed=0)
    thin = port_hin(jhin)
    ts = PathSimService(
        create_backend("torch", thin, compile_metapath("APVPA", thin.schema),
                       device="cpu"),
        config=ServeConfig(max_wait_ms=0.5, warm=False, topk_mode="ann",
                           ann_shadow_every=0, compact_auto=False))
    try:
        snap = ts.stats()["ann"]
        assert (snap["centroids"], snap["nprobe"], snap["cand_mult"],
                snap["variant"]) == (91, 30, 16, "rerank-all")
        c, d = half_chain_and_denominators(
            thin, compile_metapath("APVPA", thin.schema))
        rows = np.random.default_rng(1).choice(np.flatnonzero(d > 0), 96,
                                               replace=False)
        sc, ids = [], []
        for row in rows:
            av, ai = ts.topk_index(int(row), k=10, mode="ann")
            ev, ei = ts.topk_index(int(row), k=10, mode="exact")
            want = ei[np.isfinite(ev)]
            kth = ev[np.isfinite(ev)].min()
            got = set(ai[np.isfinite(av)].tolist())
            sc.append(min(float((av[np.isfinite(av)] >= kth).sum())
                          / want.size, 1.0))
            ids.append(sum(int(i) in got for i in want) / want.size)
        assert float(np.mean(sc)) >= 0.99
        assert float(np.mean(ids)) >= 0.97
    finally:
        ts.close()


def test_staleness_answers_exactly_then_refresh_as_jax():
    """An updated row is never answered from the stale index: it falls
    back to exact (counted) until refresh re-embeds it; refresh moves the
    index epoch to the service token. The fallback counts, the update's
    ``ann_stale_rows`` and the refresh accounting equal the JAX
    service's. The index spans the graph's capacity rows, so an author
    appended into the headroom is an affected row: ``stale`` too, and
    answered through the index once refreshed."""
    js, ts = _services(*_graphs(headroom=0.25), ann_auto_refresh=False)
    try:
        ap = ts.hin.blocks["author_of"]
        row, col = int(ap.rows[0]), int(ap.cols[0])
        recs = {"remove_edges": [{"rel": "author_of", "src_row": row,
                                  "dst_row": col}],
                "add_nodes": [{"type": "author", "id": "a_new"}],
                "add_edges": [{"rel": "author_of", "src": "a_new",
                               "dst_row": col}]}
        info_j = js.update(jdelta.delta_from_records(js.hin, **recs))
        info_t = ts.update(tdelta.delta_from_records(ts.hin, **recs))
        assert info_t["mode"] == info_j["mode"] == "delta"
        assert info_t["ann_stale_rows"] == info_j["ann_stale_rows"] > 0
        assert ts._ann.index.stale[row]
        assert ts.health()["index"]["epoch"] != list(ts.consistency_token)
        assert ts.health()["index"] == js.health()["index"]
        before = _fallbacks()
        for svc in (js, ts):
            for r in (row, svc.n - 1, row):
                svc.topk_index(r, k=10, mode="ann")
        jd, td = _delta_counts(before, _fallbacks())
        assert td == jd and td["stale"] == 3 and td["uncovered"] == 0
        assert ts._ann.index.n == ts.index.padded_size
        for r in (row, ts.n - 1):
            got = ts.topk_index(r, k=10, mode="ann")
            assert _same(got, ts.topk_index(r, k=10, mode="exact"))
            assert _same(got, js.topk_index(r, k=10, mode="ann"))
        rj, rt = js.refresh_index(), ts.refresh_index()
        rj.pop("ms"), rt.pop("ms")
        assert rt == rj and rt["stale_remaining"] == 0
        assert rt["uncovered_rows"] == 0 and rt["refreshed"] >= 2
        assert ts.health()["index"]["epoch"] == list(ts.consistency_token)
        assert ts.health()["modes"]["ann"] == js.health()["modes"]["ann"]
        before = _fallbacks()
        for r in (row, ts.n - 1):
            got = ts.topk_index(r, k=10, mode="ann")
            assert _same(got, ts.topk_index(r, k=10, mode="exact"))
            assert _same(got, js.topk_index(r, k=10, mode="ann"))
        assert _fallbacks()[1] == before[1]  # answered through the index
        assert ts.stats()["ann"] == js.stats()["ann"]
    finally:
        js.close()
        ts.close()


def test_no_index_fallback_counted():
    jhin, thin = _graphs()
    js, ts = _services(jhin, thin, topk_mode="exact")
    try:
        assert ts._ann is None and ts.health()["index"] is None
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(3, k=5, mode="ann")
            assert _same(got, svc.topk_index(3, k=5, mode="exact"))
        jd, td = _delta_counts(before, _fallbacks())
        assert td == jd and td["no_index"] == 1
        assert ts.ann_fallback_reason(3, "ann") == "no_index"
        assert ts.ann_fallback_reason(3) is None  # exact by default
        with pytest.raises(ValueError, match="unknown topk mode"):
            ts.topk_index(3, k=5, mode="bogus")
        # a learned query on a replica without towers or index answers
        # exactly (learned no_towers, then ann no_index), as in JAX
        for svc in (js, ts):
            got = svc.topk_index(3, k=5, mode="learned")
            assert _same(got, svc.topk_index(3, k=5, mode="exact"))
        # learned mode without a checkpoint trains towers in the service
        # (as the JAX service does) and answers through them
        ls = PathSimService(ts.backend, config=ServeConfig(
            topk_mode="learned", warm=False, learned_steps=5,
            learned_cand_mult=4096, learned_shadow_every=0))
        try:
            assert ls.stats()["learned"]["enabled"]
            assert _same(ls.topk_index(3, k=5),
                         ts.topk_index(3, k=5, mode="exact"))
        finally:
            ls.close()
    finally:
        js.close()
        ts.close()


def test_shadow_gate_trips_to_exact_then_refresh_resets():
    """A recall floor above 1 trips the gate: every query then answers
    exactly (``low_confidence``); a refresh starts the gate fresh."""
    jhin, thin = _graphs()
    js, ts = _services(jhin, thin, ann_shadow_every=1, ann_min_shadow=2,
                       ann_recall_floor=1.01)
    try:
        c, d = half_chain_and_denominators(
            thin, compile_metapath("APVPA", thin.schema))
        eligible = np.flatnonzero(d > 0)
        for svc in (js, ts):
            for row in np.random.default_rng(2).choice(eligible, 8,
                                                       replace=False):
                svc.topk_index(int(row), k=10, mode="ann")
        assert not ts._ann.enabled and not js._ann.enabled
        # how many samples land before the gate trips depends on thread
        # timing (the shadow runs after its future resolves), on both
        # sides alike; the rest of the block is deterministic
        racy = ("shadow_samples", "shadow_recall")
        tsnap, jsnap = ts.stats()["ann"], js.stats()["ann"]
        assert tsnap["shadow_samples"] >= 2 and jsnap["shadow_samples"] >= 2
        assert ({k: v for k, v in tsnap.items() if k not in racy}
                == {k: v for k, v in jsnap.items() if k not in racy})
        before = _fallbacks()
        for svc in (js, ts):
            got = svc.topk_index(int(eligible[0]), k=10, mode="ann")
            assert _same(got, svc.topk_index(int(eligible[0]), k=10,
                                             mode="exact"))
        jd, td = _delta_counts(before, _fallbacks())
        assert td == jd and td["low_confidence"] == 1
        ts.refresh_index()
        assert ts._ann.enabled and ts.stats()["ann"]["shadow_samples"] == 0
    finally:
        js.close()
        ts.close()


def _loop(loop, svc, reqs):
    out = io.StringIO()
    assert loop(svc, io.StringIO("\n".join(map(json.dumps, reqs)) + "\n"),
                out) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_serve_loop_ann_mode_and_refresh_index_op_as_jax():
    js, ts = _services(*_graphs(headroom=0.25), topk_mode="exact",
                       index_path=None, ann_auto_refresh=False)
    js.close()
    ts.close()
    # an exact-default service holding an index: per-request ann
    jhin, thin = _graphs(headroom=0.25)
    js, ts = _services(jhin, thin, ann_auto_refresh=False)
    try:
        ap = ts.hin.blocks["author_of"]
        row, col = int(ap.rows[3]), int(ap.cols[3])
        reqs = [
            {"id": 1, "op": "topk", "row": row, "k": 6, "mode": "ann"},
            {"id": 2, "op": "topk", "row": 9, "k": 6, "mode": "exact"},
            {"id": 3, "op": "update", "remove_edges": [
                {"rel": "author_of", "src_row": row, "dst_row": col}]},
            {"id": 4, "op": "health"},
            {"id": 5, "op": "topk", "row": row, "k": 6, "mode": "ann"},
            {"id": 6, "op": "refresh_index"},
            {"id": 7, "op": "health"},
            {"id": 8, "op": "topk", "row": row, "k": 6},
            {"id": 9, "op": "stats"},
            {"id": 10, "op": "topk", "row": row, "k": 6, "mode": "nope"},
            {"id": 11, "op": "shutdown"},
        ]
        jr, tr = _loop(jloop, js, reqs), _loop(serve_loop, ts, reqs)
        assert [r["ok"] for r in tr] == [r["ok"] for r in jr]
        for a, b in zip(jr, tr):
            res_a, res_b = a.get("result"), b.get("result")
            if b["id"] in (1, 2, 5, 8):
                assert res_b == res_a, b["id"]
            if b["id"] == 3:
                assert res_b["ann_stale_rows"] == res_a["ann_stale_rows"]
            if b["id"] == 6:
                res_a.pop("ms"), res_b.pop("ms")
                assert res_b == res_a and res_b["refreshed"] >= 1
            if b["id"] in (4, 7):
                assert res_b["index"] == res_a["index"]
                assert res_b["modes"]["ann"] == res_a["modes"]["ann"]
            if b["id"] == 9:
                assert set(res_b["ann"]) == set(res_a["ann"])
                assert res_b["ann"] == res_a["ann"]
        h4, h7 = tr[3]["result"], tr[6]["result"]
        assert h4["index"]["epoch"] != [h4["base_fp"], h4["delta_seq"]]
        assert h7["index"]["epoch"] == [h7["base_fp"], h7["delta_seq"]]
        assert "unknown topk mode" in tr[9]["error"]
    finally:
        js.close()
        ts.close()


def test_ann_answers_unchanged_across_a_forced_compaction():
    """The compaction swap leaves the ANN state alone (same index, same
    snapshots): answers before and after are identical, and ann-mode
    rows still answer through the index (no fallback counted)."""
    jhin, thin = _graphs(headroom=0.25)
    _, ts = _services(jhin, thin)
    try:
        rows = [3, 40, 77, 150, 222]
        before = [ts.topk_index(r, k=8) for r in rows]
        ann0, token0 = ts._ann, ts.consistency_token
        res = ts.compact()
        assert res["swapped"] and ts.consistency_token == token0
        assert ts._ann is ann0 and ts._ann.index.token == token0
        ts.invalidate(memo=False)  # answers come from the lane again
        fb = _fallbacks()[1]
        for r, b in zip(rows, before):
            assert _same(ts.topk_index(r, k=8), b), r
        assert _fallbacks()[1] == fb
    finally:
        ts.close()
