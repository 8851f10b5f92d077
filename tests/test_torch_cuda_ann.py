"""The ANN tier's probe on the card: the route and the shortlist probe as
torch ops on CUDA against the same index probing on the CPU and against
the host route, every centroid tied, and an ANN service on the card
answering as the same service on the CPU with 0 compiles after warmup.
These tests need a CUDA card (marker ``cuda``) and skip without one;
they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ann.py
"""

import threading

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.index import CentroidIndex, build_index
from distributed_pathsim_tpu_torch.index.build import (
    half_chain_and_denominators,
)
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.utils.compile_counter import (
    CompileCounter,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graph():
    hin = synthetic_hin(3000, 5000, 64, seed=9, materialize_ids=True)
    mp = compile_metapath("APVPA", hin.schema)
    c, d = half_chain_and_denominators(hin, mp)
    return hin, mp, c, d


def _pair(c, d, **kw):
    cpu = build_index(c=c, d=d, device="cpu", **kw)
    dev = CentroidIndex(
        centroids=cpu.centroids, members=cpu.members, packed=cpu.packed,
        cluster_of=cpu.cluster_of, slot_of=cpu.slot_of, token=cpu.token,
        meta=cpu.meta, device="cuda")
    return cpu, dev


def test_device_route_equals_cpu_route_and_host_route_set(card, graph):
    _, _, c, d = graph
    cpu, dev = _pair(c, d)
    rows = np.arange(0, 3000, 11)
    for nprobe in (1, 8, 36, cpu.n_centroids):
        hm, hc = cpu.route_batch_host(rows, nprobe)
        cm, cc = cpu.route_batch(rows, nprobe)
        gm, gc = dev.route_batch(rows, nprobe)
        assert gm.dtype == np.int32 and gc.dtype == np.int32
        # the card's GEMM may round differently from the host's: the
        # cluster SETS agree wherever the nprobe-th and (nprobe+1)-th
        # similarities are apart
        q = cpu.embedding_of(rows).astype(np.float64)
        sims = -np.sort(-(q @ cpu.centroids.T.astype(np.float64)), axis=1)
        for b in range(rows.shape[0]):
            if nprobe < cpu.n_centroids:
                gap = sims[b, nprobe - 1] - sims[b, nprobe]
                if gap <= 1e-6 * abs(sims[b, nprobe - 1]):
                    continue
            assert set(gc[b]) == set(hc[b]) == set(cc[b]), (nprobe, b)
            assert sorted(gm[b]) == sorted(hm[b]), (nprobe, b)


def test_device_probe_equals_cpu_probe(card, graph):
    _, _, c, d = graph
    cpu, dev = _pair(c, d)
    rows = np.arange(0, 3000, 13)
    cs, cm = cpu.probe_batch(rows, 8)
    gs, gm = dev.probe_batch(rows, 8)
    same = (cm == gm).all(axis=1)
    assert same.mean() > 0.95  # near-tied centroid sets may differ
    fin = np.isfinite(cs[same])
    assert (np.isfinite(gs[same]) == fin).all()
    np.testing.assert_allclose(gs[same][fin], cs[same][fin], rtol=1e-6,
                               atol=1e-6 * np.abs(cs[same][fin]).max())
    masked = (gm < 0) | (gm == rows[:, None])
    assert np.isneginf(gs[masked]).all()


def test_tied_centroids_keep_the_lowest_ids_on_the_card(card):
    rng = np.random.default_rng(0)
    k, cap, dim, n = 48, 8, 32, 300
    packed = np.zeros((k, cap, dim), np.float32)
    members = np.full((k, cap), -1, np.int32)
    cluster_of = (np.arange(n) % k).astype(np.int32)
    slot_of = (np.arange(n) // k).astype(np.int32)
    members[cluster_of, slot_of] = np.arange(n)
    packed[cluster_of, slot_of] = rng.standard_normal((n, dim))
    cent = np.tile(rng.standard_normal(dim).astype(np.float32), (k, 1))
    idx = CentroidIndex(centroids=cent, members=members, packed=packed,
                        cluster_of=cluster_of, slot_of=slot_of,
                        token=("fp", 0), meta={}, device="cuda")
    for nprobe in (1, 7, 47):
        _, top_c = idx.route_batch(np.arange(n), nprobe)
        assert (top_c == np.arange(nprobe)).all(), nprobe


@pytest.mark.parametrize("variant", ["rerank-all", "shortlist"])
def test_ann_service_on_the_card_answers_as_on_the_cpu(card, variant):
    hin = tdl.with_headroom(
        synthetic_hin(2500, 4000, 48, seed=3, materialize_ids=True), 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    cfg = dict(max_batch=16, k_default=10, topk_mode="ann",
               ann_variant=variant, ann_shadow_every=4, compact_auto=False)
    host = PathSimService(create_backend("torch", hin, mp, device="cpu"),
                          config=ServeConfig(warm=False, **cfg))
    svc = PathSimService(create_backend("torch", hin, mp, device="cuda"),
                         config=ServeConfig(**cfg))
    try:
        assert not svc._ann.route_on_host
        assert svc._ann.index.torch_device().type == "cuda"
        rows = np.random.default_rng(1).integers(0, 2500, (8, 24))
        got = [[None] * rows.shape[1] for _ in range(rows.shape[0])]
        with CompileCounter() as compiles:
            def client(i):
                for j, r in enumerate(rows[i]):
                    got[i][j] = svc.topk_index(int(r), 10)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(rows.shape[0])]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            # the host service's answers to the same rows, before the
            # update as the card's were
            answers = [(int(r), a, host.topk_index(int(r), 10, mode="exact"),
                        host.topk_index(int(r), 10))
                       for i in range(1, rows.shape[0])
                       for r, a in zip(rows[i], got[i])]
            recs = {"remove_edges": [{"rel": "author_of", "src_row": 0,
                                      "dst_row": int(hin.blocks[
                                          "author_of"].cols[0])}]}
            delta = tdl.delta_from_records(svc.hin, **recs)
            assert svc.update(delta)["mode"] == "delta"
            host.update(tdl.delta_from_records(host.hin, **recs))
            assert svc.refresh_index()["stale_remaining"] == 0
            host.refresh_index()
            after = [svc.topk_index(int(r), 10) for r in rows[0]]
        assert compiles.count == 0, compiles.by_kind
        # row set 0 is compared after the update, the rest before it
        answers += [(int(r), a, host.topk_index(int(r), 10, mode="exact"),
                     host.topk_index(int(r), 10))
                    for r, a in zip(rows[0], after)]
        same_as_host, recall = 0, []
        for r, (v, i), (ev, ei), (hv, hi) in answers:
            if set(i.tolist()) == set(ei.tolist()):
                # covered: bit-identical to the exact answer
                assert np.array_equal(v, ev) and np.array_equal(i, ei), r
            same_as_host += np.array_equal(v, hv) and np.array_equal(i, hi)
            fin = ev[np.isfinite(ev)]
            if fin.size:
                recall.append(min(float((v[np.isfinite(v)] >= fin.min())
                                        .sum()) / fin.size, 1.0))
        # the card's route may differ from the host's on near-tied
        # centroids only
        assert same_as_host >= 0.95 * len(answers)
        assert float(np.mean(recall)) >= 0.99
        assert svc.stats()["ann"]["shadow_samples"] > 0
    finally:
        svc.close()
        host.close()
