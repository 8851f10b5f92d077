"""The CUDA kernels on the card against their plain versions, zero
tolerance. These tests need a CUDA card (marker ``cuda``) and skip
without one; they import only the port, so they run on a machine with
no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import planner
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def _factor(spec, n, device, seed=4):
    hin = synthetic_hin(n, int(n * 1.5), 24, seed=seed)
    c = planner.dense_half(hin, compile_metapath(spec, hin.schema),
                           dtype=np.float64)
    return factor_from_arrays(c, c @ c.sum(0), device)


@pytest.mark.parametrize("spec,n", [("APVPA", 1031), ("APA", 517)])
@pytest.mark.parametrize("k,mask_self", [(1, True), (10, False), (16, True)])
def test_topk_kernel_equals_plain(card, spec, n, k, mask_self):
    c, d = _factor(spec, n, card)
    cv, cc = ck.topk_twopass_candidates(c, d, k, mask_self)
    pv, pc = ck.topk_twopass_candidates_plain(c, d, k, mask_self)
    assert torch.equal(cv, pv) and torch.equal(cc, pc)
    fv, fc = ck.fused_topk_twopass(c, d, k=k, mask_self=mask_self)
    gv, gc = ck.fused_topk_twopass_plain(c, d, k=k, mask_self=mask_self)
    assert torch.equal(fv, gv) and torch.equal(fc, gc)


@pytest.mark.parametrize("spec,n", [("APVPA", 1031), ("APA", 517)])
def test_scores_kernel_equals_plain(card, spec, n):
    c, d = _factor(spec, n, card)
    assert torch.equal(ck.fused_scores(c, d), ck.fused_scores_plain(c, d))


def test_backend_counts_launches_and_matches_oracle(card):
    hin = synthetic_hin(900, 1350, 20, seed=9)
    mp = compile_metapath("APVPA", hin.schema)
    b = create_backend("torch", hin, mp)
    ck.reset_launches()
    vals, idxs = b.topk(k=10)
    scores = b.all_pairs_scores()
    assert ck.LAUNCHES == {"topk_twopass_candidates": 1, "fused_scores": 1,
                           "topk_rect_candidates": 0, "topk_fold": 0,
                           "topk_twopass_exact": 0, "topk_fold_exact": 0}
    cpu = create_backend("torch", hin, mp, device="cpu")
    cv, ci = cpu.topk(k=10)
    np.testing.assert_array_equal(vals, cv)
    np.testing.assert_array_equal(idxs, ci)
    np.testing.assert_array_equal(scores, cpu.all_pairs_scores())

