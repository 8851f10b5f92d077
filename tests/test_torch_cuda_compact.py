"""The rest of the serving lanes on the card: a compaction hot-swaps a
service's backend with the consistency token, the fingerprint and the
caches kept (and the kernels on the compacted factor equal a fresh
backend's), a per-request APA answers as the same service on the CPU,
and an engine whose chain ``torch-sparse`` refuses degrades to ``torch``
on the card, never to the host. These tests need a CUDA card (marker
``cuda``) and skip without one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_compact.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from torch_port_util import make_delta, random_delta_spec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def _graph(n=1200, seed=7):
    return tdl.with_headroom(
        synthetic_hin(n, int(n * 1.5), 40, n_topics=64, topics_per_paper=1.4,
                      seed=seed, materialize_ids=True), 0.25)


def _service(hin, device, backend="torch", **cfg):
    mp = compile_metapath("APVPA", hin.schema)
    return PathSimService(create_backend(backend, hin, mp, device=device),
                          config=ServeConfig(max_batch=8, compact_auto=False,
                                             **cfg))


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(a[0], b[0], err_msg=msg)
    np.testing.assert_array_equal(a[1], b[1], err_msg=msg)


def test_compaction_on_the_card_keeps_token_and_caches(card):
    hin = _graph()
    svc, host = _service(hin, card), _service(hin, "cpu")
    try:
        spec = random_delta_spec(hin, np.random.default_rng(3), n_changes=30,
                                 append=True)
        for s in (svc, host):
            assert s.update(make_delta(tdl, spec))["mode"] == "delta"
        rows = np.arange(0, svc.n, 37)
        before = [svc.topk_index(int(r), 10) for r in rows]
        tok, fp, entries = svc.consistency_token, svc._fp, len(
            svc.result_cache)
        res = svc.compact()
        assert res["swapped"] and res["compiles"] == 0, res
        assert svc.consistency_token == tok and svc._fp == fp
        assert len(svc.result_cache) == entries
        assert svc.backend.device.type == "cuda"
        for r, a in zip(rows, before):
            _equal(svc.topk_index(int(r), 10), a)
        for r in range(1, svc.n, 53):  # fresh rows: dispatched on the card
            _equal(svc.topk_index(r, 10), host.topk_index(r, 10), r)
        fresh = create_backend("torch", svc.hin, svc.metapath, device=card)
        for k in (10, 20):  # K1, K4 on the re-padded factor
            _equal(svc.backend.topk(k=k), fresh.topk(k=k), k)
        np.testing.assert_array_equal(svc.backend.all_pairs_scores(),
                                      fresh.all_pairs_scores())
    finally:
        svc.close()
        host.close()


def test_per_request_apa_on_the_card_equals_the_cpu(card):
    hin = _graph(seed=9)
    svc, host = _service(hin, card), _service(hin, "cpu")
    try:
        for spec in ("APA", "APTPA"):
            for r in range(0, svc.n, 29):
                _equal(svc.topk_index(r, 8, metapath=spec),
                       host.topk_index(r, 8, metapath=spec), (spec, r))
            eng = svc._engines[spec]
            assert eng.backend.device.type == "cuda"
            assert eng.fallback_from is None
        np.testing.assert_array_equal(svc.scores_index(4, metapath="APA"),
                                      host.scores_index(4, metapath="APA"))
    finally:
        svc.close()
        host.close()


def test_engine_fallback_on_the_card_stays_on_the_card(card):
    hin = _graph(n=800, seed=11)
    svc = _service(hin, card, backend="torch-sparse")
    oracle = _service(hin, "cpu", backend="numpy")
    try:
        spec = "APVPTPA"  # closed, not a palindrome: torch-sparse refuses
        for r in range(0, svc.n, 41):
            _equal(svc.topk_index(r, 5, metapath=spec),
                   oracle.topk_index(r, 5, metapath=spec), r)
        eng = svc.stats()["plan"]["engines"][spec]
        assert eng["backend"] == "torch"
        assert eng["fallback_from"] == "torch-sparse"
        assert svc._engines[spec].backend.device.type == "cuda"
    finally:
        svc.close()
        oracle.close()
