"""The learned tier on the card: the tower forward and the probe as torch
ops on CUDA against the same towers on the CPU, and a learned service on
the card answering bit-identically to the exact lane — through the
cold-start append and ``refresh_towers`` — with 0 compiles after warmup.
The towers are seeded random weights saved through the port's own
checkpoint writer (the JAX package's format; no JAX here). These tests
need a CUDA card (marker ``cuda``) and skip without one; they import
only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_learned.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.index.build import (
    half_chain_and_denominators,
)
from distributed_pathsim_tpu_torch.learned import (
    InductiveEncoder,
    LearnedState,
    save_towers,
)
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from distributed_pathsim_tpu_torch.serving.cache import graph_fingerprint
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
    hin = tdl.with_headroom(
        synthetic_hin(600, 1000, 16, seed=9, materialize_ids=True), 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    c, d = half_chain_and_denominators(hin, mp)
    return hin, mp, c, d


def _encoder(v, hidden=32, dim=16, seed=4):
    rng = np.random.default_rng(seed)
    d_pos = np.geomspace(1.0, 1e4, 12)
    quad_t = 1.0 / d_pos
    f = v + 1 + quad_t.size
    layers = [((rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32),
               (rng.standard_normal(s[1]) * 0.05).astype(np.float32))
              for s in ((f, hidden), (hidden, hidden), (hidden, dim))]
    return InductiveEncoder(layers=layers, quad_t=quad_t, quad_w=quad_t,
                            deg_denom=10.0, target_scale=1.0,
                            variant="rowsum", metapath="APVPA",
                            meta={"steps": 0, "seed": seed})


def test_embed_and_probe_on_the_card_equal_the_cpu(card, graph):
    _, _, c, d = graph
    enc = _encoder(c.shape[1])
    got = enc.embed(c, d, device=card)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(),
                               enc.embed(c, d, device="cpu").numpy(),
                               rtol=1e-6, atol=1e-6)
    on_card = LearnedState(enc, c, d, cand_mult=16, device=card)
    on_cpu = LearnedState(enc, c, d, cand_mult=16, device="cpu")
    try:
        rows = np.flatnonzero(d > 0)[:32]
        cand = on_card.probe_batch(rows, 10).fetch()
        want = on_cpu.probe_batch(rows, 10).fetch()
        assert cand.shape == want.shape == (32, 160)
        sims = on_cpu._emb[torch.as_tensor(rows)] @ on_cpu._emb.T
        for b, row in enumerate(rows):
            assert row not in cand[b]
            # sets equal outside near-ties at the C-th similarity
            s = np.sort(sims[b].numpy())[::-1]
            if s[159] - s[160] > 1e-5 * max(abs(s[159]), 1e-30):
                assert set(cand[b].tolist()) == set(want[b].tolist()), row
    finally:
        on_card.close()
        on_cpu.close()


def test_learned_service_on_the_card(card, graph, tmp_path):
    hin, mp, c, d = graph
    path = str(tmp_path / "towers.npz")
    save_towers(path, _encoder(c.shape[1]), (graph_fingerprint(hin), 0))
    svc = PathSimService(
        create_backend("torch", hin, mp, device="cuda"),
        config=ServeConfig(max_batch=8, topk_mode="learned",
                           learned_checkpoint=path, learned_cand_mult=100,
                           learned_shadow_every=0,
                           learned_auto_refresh=False, compact_auto=False))
    try:
        lr = svc._learned
        assert lr._emb.device.type == "cuda"
        rows = np.flatnonzero(lr.d[: svc.n] > 0)[::7]
        with CompileCounter() as compiles:
            for row in rows:
                got = svc.topk_index(int(row), k=10)
                want = svc.topk_index(int(row), k=10, mode="exact")
                # cand_mult 100 at k = 10 takes every other of the
                # graph's 750 rows: coverage is total, bit-identical
                assert np.array_equal(got[0], want[0]), row
                assert np.array_equal(got[1], want[1]), row
        assert compiles.count == 0, compiles.by_kind
        n0 = svc.n
        papers = hin.indices["paper"].ids
        svc.update(tdl.delta_from_records(
            svc.hin,
            add_nodes=[{"type": "author", "id": "cold_author"}],
            add_edges=[{"rel": "author_of", "src": "cold_author",
                        "dst": papers[p]} for p in (3, 17, 40)]))
        assert svc.learned_fallback_reason(n0, "learned") == "stale"
        exact = svc.topk_index(n0, k=10, mode="exact")
        before = svc.topk_index(n0, k=10)
        res = svc.refresh_towers()
        assert res["appended"] == 1 and res["stale_remaining"] == 0
        assert svc.learned_fallback_reason(n0, "learned") is None
        after = svc.topk_index(n0, k=10)
        for got in (before, after):
            assert np.array_equal(got[0], exact[0])
            assert np.array_equal(got[1], exact[1])
        assert svc.stats()["learned"]["cold_start_ratio"] == 1.0
    finally:
        svc.close()
