"""Compressed factors, the symmetric half-sweep and the batch tier on
the card, each against the same call on the CPU: the packed arms of
``torch-sparse`` (K3 on the decoded factor) through a delta, the
symmetric half-sweep, and a small campaign whose block GEMMs run in f64
on the card (``backend_mode == "cuda"``, never the host arm). These
tests need a CUDA card (marker ``cuda``) and skip without one; they
import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_batch.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.batch import (
    BatchEngine,
    run_simjoin_campaign,
    run_topk_campaign,
)
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from torch_port_util import make_delta, random_delta_spec

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def _equal(a, b, msg=""):
    np.testing.assert_array_equal(a[0], b[0], err_msg=msg)
    np.testing.assert_array_equal(a[1], b[1], err_msg=msg)


@pytest.mark.parametrize("fmt", ["blocked", "bitpacked"])
def test_packed_arm_and_delta_on_the_card(card, fmt):
    hin = tdl.with_headroom(synthetic_hin(3000, 4500, 40, seed=3,
                                          materialize_ids=True), 0.25)
    mp = compile_metapath("APVPA", hin.schema)
    on = {d: create_backend("torch-sparse", hin, mp, device=d,
                            factor_format=fmt, tile_rows=1024)
          for d in (card, "cpu")}
    on["cpu"]._rect_kernel = True  # K3's plain version on the CPU
    ck.reset_launches()
    got = on[card].topk_scores(k=10)
    assert ck.LAUNCHES["topk_rect_candidates"] == on[card]._n_live_tiles
    _equal(got, on["cpu"].topk_scores(k=10), fmt)
    plan = tdl.plan_delta(hin, make_delta(tdl, random_delta_spec(
        hin, np.random.default_rng(5), append=True)), mp)
    assert not plan.fallback, plan.reason
    for b in on.values():
        b.apply_delta(plan)
    _equal(on[card].topk_scores(k=10), on["cpu"].topk_scores(k=10),
           f"{fmt} after the delta (limbs split anew)")
    assert on[card].factor_info() == on["cpu"].factor_info()


def test_symmetric_sweep_on_the_card(card):
    hin = synthetic_hin(5000, 7500, 48, seed=4)
    mp = compile_metapath("APVPA", hin.schema)
    b = create_backend("torch-sparse", hin, mp, device=card, tile_rows=1024)
    cpu = create_backend("torch-sparse", hin, mp, device="cpu",
                         tile_rows=1024)
    ck.reset_launches()
    sym = b.topk_scores(k=10, symmetric=True)
    assert not any(ck.LAUNCHES.values())  # torch ops, not K3
    _equal(sym, b.topk_scores(k=10), "symmetric vs the full sweep (K3)")
    _equal(sym, cpu.topk_scores(k=10, symmetric=True), "card vs CPU")


def test_campaign_gemm_on_the_card(card, tmp_path):
    hin = synthetic_hin(600, 900, 20, seed=6)
    mp = compile_metapath("APVPA", hin.schema)
    dev = BatchEngine(hin, mp, block_rows=64, factor_format="bitpacked")
    host = BatchEngine(hin, mp, block_rows=64, device="cpu")
    assert dev.backend_mode == "cuda" and host.backend_mode == "numpy"
    a = run_topk_campaign(dev, 10, checkpoint_dir=str(tmp_path / "ck"))
    b = run_topk_campaign(host, 10)
    _equal((a.vals, a.idxs), (b.vals, b.idxs), "campaign card vs host")
    for grouping in ("degree", "centroid"):
        x = run_simjoin_campaign(dev, 0.02, grouping=grouping)
        y = run_simjoin_campaign(host, 0.02, grouping=grouping)
        np.testing.assert_array_equal(x.rows, y.rows)
        np.testing.assert_array_equal(x.scores, y.scores)
