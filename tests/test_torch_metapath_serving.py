"""Port parity: per-request secondary metapaths (the ``metapath`` field of
``topk`` / ``scores``) on the port's PathSimService against the JAX
package's, on the CPU, same numpy-seeded synthetic graph with topics.
APA and APTPA answer through their own engines and coalescer lanes,
bit-identical to the JAX service (values and tie order) and to dedicated
backends; the default lane is unchanged; bad metapaths, the engine limit
and the protocol field answer as the JAX service does; an ``update``
drops the engines (``engines_dropped`` / ``memo_invalidated`` equal to
the JAX result); concurrent mixed lanes resolve correctly; a closed
asymmetric chain on ``torch-sparse`` degrades to ``numpy`` with
``fallback_from``; and the port's exact-count guard holds per engine."""

import threading

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.serving.protocol import handle_request as jhandle
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.protocol import handle_request
from distributed_pathsim_tpu_torch.utils import logging as tlog
from torch_port_util import overflow_hins, port_hin

CFG = {"max_wait_ms": 1.0, "warm": False, "compact_auto": False}
BACKENDS = {"jax": ("torch", {"device": "cpu"}),
            "jax-sparse": ("torch-sparse", {"device": "cpu"})}


@pytest.fixture
def services():
    """(JAX service, port service, port graph) over one graph, the JAX
    side without a tuning table; built by ``make(backend, **cfg)``."""
    prev = jtuning._state.enabled
    jtuning.set_enabled(False)
    made = []

    def make(jbackend="jax", **cfg):
        jhin = jsyn.synthetic_hin(32, 60, 6, n_topics=5,
                                  topics_per_paper=1.4, seed=21,
                                  materialize_ids=True)
        thin = port_hin(jhin)
        tname, opts = BACKENDS[jbackend]
        js = JService(jcreate(jbackend, jhin, jmeta.compile_metapath(
            "APVPA", jhin.schema)), config=JConfig(**CFG, **cfg))
        ts = PathSimService(create_backend(tname, thin, compile_metapath(
            "APVPA", thin.schema), **opts), config=ServeConfig(**CFG, **cfg))
        made.extend([js, ts])
        return js, ts, thin

    try:
        yield make
    finally:
        for svc in made:
            svc.close()
        jtuning.set_enabled(prev)


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(a[0], b[0], err_msg=msg)
    np.testing.assert_array_equal(a[1], b[1], err_msg=msg)


def test_per_request_metapath_bit_identical_to_jax_service(services):
    js, ts, thin = services()
    for spec in ("APA", "APTPA"):
        dedicated = create_backend("numpy", thin,
                                   compile_metapath(spec, thin.schema))
        for row in range(ts.n):
            got = ts.topk_index(row, k=5, metapath=spec)
            _equal(got, js.topk_index(row, k=5, metapath=spec), spec)
            _equal(got, dedicated.topk_row(row, k=5), spec)
    # the engines share the sub-chain memo: the A·P factor crossed lanes
    st, jst = ts.stats(), js.stats()
    assert set(st["plan"]["engines"]) == {"APA", "APTPA"}
    assert st["plan"]["memo"]["hits"] > 0
    assert st["plan"]["memo"] == jst["plan"]["memo"]
    assert st["plan"]["primary"]["metapath"] == "APVPA"
    for name, eng in st["plan"]["engines"].items():
        jeng = jst["plan"]["engines"][name]
        assert {k: v for k, v in eng.items() if k != "backend"} == {
            k: v for k, v in jeng.items() if k != "backend"}


def test_default_metapath_unchanged(services):
    js, ts, _ = services()
    v1 = ts.topk_index(2, k=5)
    _equal(v1, ts.topk_index(2, k=5, metapath="APVPA"))  # explicit
    _equal(v1, ts.topk_index(2, k=5, metapath=" "))      # blank
    _equal(v1, js.topk_index(2, k=5))
    assert ts.stats()["plan"]["engines"] == {}


def test_metapath_validation_answers_as_jax(services):
    js, ts, _ = services()
    for i, spec in enumerate(("APV", "AXA", "APTPAX")):
        req = {"id": i, "op": "topk", "row": 0, "k": 5, "metapath": spec}
        a, b = jhandle(js, dict(req)), handle_request(ts, dict(req))
        assert not a["ok"] and not b["ok"], spec
        assert b["error"] == a["error"], spec
        with pytest.raises((KeyError, ValueError)):
            ts.topk_index(0, k=5, metapath=spec)
    # a row past the metapath's source range: a KeyError, as in JAX
    req = {"id": 9, "op": "topk", "row": 10_000, "metapath": "APA"}
    assert handle_request(ts, dict(req))["error"] == jhandle(
        js, dict(req))["error"]
    assert ts.stats()["plan"]["engines"] == {}


def test_scores_and_protocol_metapath(services):
    js, ts, thin = services()
    dedicated = create_backend("numpy", thin,
                               compile_metapath("APA", thin.schema))
    want = dedicated.scores_rows(np.asarray([4]))[0]
    np.testing.assert_array_equal(ts.scores_index(4, metapath="APA"), want)
    np.testing.assert_array_equal(js.scores_index(4, metapath="APA"), want)
    ids = thin.indices["author"].ids
    for req in ({"id": 1, "op": "topk", "row": 4, "k": 3, "metapath": "APA"},
                {"id": 2, "op": "scores", "row": 4, "metapath": "APTPA"},
                {"id": 3, "op": "topk", "source_id": ids[6], "k": 4,
                 "metapath": "APTPA"}):
        a, b = jhandle(js, dict(req)), handle_request(ts, dict(req))
        assert b["ok"] and a["ok"], (req, b)
        assert b["result"] == a["result"], req


def test_update_drops_engines_and_matches_jax(services):
    js, ts, _ = services()
    for svc in (js, ts):
        svc.topk_index(1, k=5, metapath="APA")  # engines built pre-delta
        svc.topk_index(1, k=5, metapath="APTPA")
    blk = ts.hin.blocks["author_of"]
    removes = [{"rel": "author_of", "src_row": int(blk.rows[0]),
                "dst_row": int(blk.cols[0])}]
    a = js.update(jdl.delta_from_records(js.hin, remove_edges=removes))
    b = ts.update(tdl.delta_from_records(ts.hin, remove_edges=removes))
    assert b["engines_dropped"] == a["engines_dropped"] == 2
    assert b["memo_invalidated"] == a["memo_invalidated"] > 0
    assert {k: v for k, v in b.items() if k != "ms"} == {
        k: v for k, v in a.items() if k != "ms"}
    assert ts.stats()["plan"]["engines"] == {}
    # post-delta: the engines rebuild lazily against the new graph
    for spec in ("APA", "APTPA"):
        dedicated = create_backend("numpy", ts.hin,
                                   compile_metapath(spec, ts.hin.schema))
        for row in (0, 1, 5):
            got = ts.topk_index(row, k=5, metapath=spec)
            _equal(got, dedicated.topk_row(row, k=5), spec)
            _equal(got, js.topk_index(row, k=5, metapath=spec), spec)
    assert ts.stats()["plan"]["memo"] == js.stats()["plan"]["memo"]


def test_concurrent_mixed_lanes(services):
    """Concurrent mixed-metapath submits from threads: each lane forms
    its own batches and every future resolves to the JAX service's
    answer."""
    js, ts, _ = services(max_batch=8)
    specs = ("APVPA", "APA", "APTPA")
    futs, lock = [], threading.Lock()

    def client(c):
        for i in range(12):
            spec, row = specs[(c + i) % 3], (c * 7 + i) % ts.n
            fut = ts.submit_topk(row, 4, metapath=spec)
            with lock:
                futs.append((spec, row, fut))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(futs) == 48
    for spec, row, fut in futs:
        _equal(fut.result(timeout=30),
               js.topk_index(row, k=4, metapath=spec), (spec, row))
    assert ts.stats()["dispatch"]["requests"] > 0


def test_max_metapaths_limit(services):
    js, ts, _ = services(max_metapaths=1)
    ts.topk_index(0, k=3, metapath="APA")
    js.topk_index(0, k=3, metapath="APA")
    req = {"id": 1, "op": "topk", "row": 0, "k": 3, "metapath": "APTPA"}
    b, a = handle_request(ts, dict(req)), jhandle(js, dict(req))
    assert not b["ok"] and b["error"] == a["error"]
    assert "metapath engine limit (1)" in b["error"]
    assert set(ts.stats()["plan"]["engines"]) == {"APA"}
    # the engine it holds keeps answering
    _equal(ts.topk_index(3, k=3, metapath="APA"),
           js.topk_index(3, k=3, metapath="APA"))


def test_asymmetric_closed_chain_falls_back_to_numpy_on_the_cpu(services):
    js, ts, thin = services("jax-sparse")
    events = []
    tlog.set_event_sink(type("Sink", (), {
        "metric": lambda self, event, **kw: events.append((event, kw))})())
    try:
        spec = "APVPTPA"  # closed (author → author), not a palindrome
        for row in range(0, ts.n, 3):
            _equal(ts.topk_index(row, k=5, metapath=spec),
                   js.topk_index(row, k=5, metapath=spec), row)
    finally:
        tlog.set_event_sink(None)
    eng = ts.stats()["plan"]["engines"][spec]
    assert eng["backend"] == "numpy"
    assert eng["fallback_from"] == "torch-sparse"
    assert js.stats()["plan"]["engines"][spec]["fallback_from"] == \
        "jax-sparse"
    fb = [kw for name, kw in events if name == "metapath_engine_fallback"]
    assert fb and fb[0]["to"] == "numpy" and fb[0]["metapath"] == spec


def test_guard_holds_per_engine_and_a_refused_update_keeps_engines():
    """APVPA over these counts is past 2^24 (4100 x 4200 = 17.22M) while
    APA is not: an APVPA engine raises OverflowError to its request on
    every request and is never kept. A guard-tripping update on the
    patch path leaves the memo and the engines as they were."""
    _, thin = overflow_hins([[4100], [100]])
    hin = tdl.with_headroom(thin, 0.25)
    svc = PathSimService(
        create_backend("torch", hin, compile_metapath("APA", hin.schema),
                       device="cpu"),
        config=ServeConfig(max_batch=4, **CFG))
    try:
        for _ in range(2):  # no latch: the second request raises again
            with pytest.raises(OverflowError, match="2\\^24"):
                svc.topk_index(0, k=1, metapath="APVPA")
        assert svc.stats()["plan"]["engines"] == {}
        # the served lane is untouched by the engine's refusal
        _equal(svc.topk_index(0, k=1), svc.backend.topk_row(0, k=1))
    finally:
        svc.close()
    # the refused update: counts of 3000 and 2500 pass, +100 shared
    # papers put row 0 past the guard
    _, thin = overflow_hins([[3000], [2500]])
    hin = tdl.with_headroom(thin, 0.25)
    svc = PathSimService(
        create_backend("torch", hin, compile_metapath("APVPA", hin.schema),
                       device="cpu"),
        config=ServeConfig(max_batch=4, **CFG))
    try:
        svc.topk_index(1, k=1, metapath="APA")
        engines = dict(svc._engines)
        memo = svc.stats()["plan"]["memo"]
        papers = hin.blocks["author_of"].cols[
            hin.blocks["author_of"].rows == 1]
        resp = handle_request(svc, {"id": 1, "op": "update", "add_edges": [
            {"rel": "author_of", "src_row": 0, "dst_row": int(p)}
            for p in papers[:100]]})
        assert not resp["ok"] and "2^24" in resp["error"], resp
        assert svc._engines == engines
        assert svc.stats()["plan"]["memo"] == memo
    finally:
        svc.close()
