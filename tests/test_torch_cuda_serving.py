"""The serving path and delta ingestion on the card. A torch backend
patched by ``update`` must rank-all through K1 (k = 10) and K4 (k = 20)
and score all pairs through K2 exactly as a backend rebuilt from the
delta-applied graph — the kernels read C's u8 limbs, which the patch
must drop — and a served batch must equal the host f64 oracle. These
tests need a CUDA card (marker ``cuda``) and skip without one; they
import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_serving.py
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
from distributed_pathsim_tpu_torch.utils.compile_counter import (
    CompileCounter,
)
from torch_port_util import make_delta, random_delta_spec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def _graph(n=1500, seed=5):
    return tdl.with_headroom(
        synthetic_hin(n, int(n * 1.5), 40, seed=seed, materialize_ids=True),
        0.25)


def test_patched_backend_kernels_equal_rebuilt(card):
    hin = _graph()
    mp = compile_metapath("APVPA", hin.schema)
    b = create_backend("torch", hin, mp, device=card)
    # rank once first: C's limbs are now split and cached
    b.topk(k=10)
    b.all_pairs_scores()
    rng = np.random.default_rng(3)
    for step in range(2):
        d = random_delta_spec(hin, rng, n_changes=40, append=step == 1)
        plan = tdl.plan_delta(hin, make_delta(tdl, d), mp)
        assert not plan.fallback
        b.apply_delta(plan)
        hin = plan.hin_new
        rebuilt = create_backend("torch", hin, mp, device=card)
        c, rs = b._half()
        rc, rrs = rebuilt._half()
        assert torch.equal(c, rc) and torch.equal(rs, rrs)
        ck.reset_launches()
        for k, kernel in ((10, "topk_twopass_candidates"), (20, "topk_fold")):
            pv, pi = b.topk(k=k)
            rv, ri = rebuilt.topk(k=k)
            np.testing.assert_array_equal(pv, rv)
            np.testing.assert_array_equal(pi, ri)
            assert ck.LAUNCHES[kernel] >= 2, kernel
        np.testing.assert_array_equal(b.all_pairs_scores(),
                                      rebuilt.all_pairs_scores())
        assert ck.LAUNCHES["fused_scores"] >= 2


def test_served_batches_equal_the_f64_oracle(card):
    hin = _graph(n=3000, seed=8)
    mp = compile_metapath("APVPA", hin.schema)
    svc = PathSimService(create_backend("torch", hin, mp, device=card),
                         config=ServeConfig(max_batch=16, max_wait_ms=2.0,
                                            queue_depth=1024))
    try:
        rng = np.random.default_rng(1)
        rows = rng.integers(0, svc.n, 200)
        with CompileCounter() as cc:
            futs = [svc.submit_topk(int(r), 10) for r in rows]
            got = [f.result(timeout=120) for f in futs]
            oracle = create_backend("numpy", hin, mp)
            ov, oi = oracle.topk_rows(rows, k=10)
            for j in range(rows.shape[0]):
                np.testing.assert_array_equal(got[j][0], ov[j])
                np.testing.assert_array_equal(got[j][1], oi[j])
            d = random_delta_spec(hin, rng, n_changes=40, append=True)
            res = svc.update(make_delta(tdl, d))
            assert res["mode"] == "delta"
            oracle = create_backend("numpy", svc.hin, mp)
            aff = np.arange(svc.n)[:400]
            futs = [svc.submit_topk(int(r), 10) for r in aff]
            ov, oi = oracle.topk_rows(aff, k=10)
            for j, f in enumerate(futs):
                v, i = f.result(timeout=120)
                np.testing.assert_array_equal(v, ov[j])
                np.testing.assert_array_equal(i, oi[j])
        assert cc.count == 0
    finally:
        svc.close()
