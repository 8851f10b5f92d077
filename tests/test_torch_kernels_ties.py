"""Port parity of the two-pass top-k on tie-heavy rows and zero-degree
targets (tests/test_pallas.py's tie cases), and the exactness of the
two-pass design itself: K1's plain per-stripe candidates reduced by pass 2
equal the full-sort plain top-k. Zero tolerance, as in
test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from torch_port_util import assert_topk_matches_pallas, kernel_case


@pytest.fixture(scope="module")
def narrow():
    return kernel_case("narrow")


@pytest.fixture(scope="module")
def ties():
    return kernel_case("ties")


@pytest.mark.parametrize("k,mask_self", [(1, True), (10, False), (16, True)])
def test_twopass_ties_and_zero_degree_match_pallas(ties, k, mask_self):
    assert_topk_matches_pallas(*ties, k, mask_self)


def test_zero_degree_targets_score_zero(ties):
    c, d = ties
    tc, td = factor_from_arrays(c, d, "cpu")
    zero = int(np.flatnonzero(d == 0)[0])
    vals, idxs = ck.fused_topk_twopass(tc, td, k=16)
    s = ck.fused_scores(tc, td)
    assert (s[zero] == 0).all() and (s[:, zero] == 0).all()
    assert torch.isfinite(vals).all()


@pytest.mark.parametrize("k,mask_self", [(1, True), (10, True), (16, False)])
@pytest.mark.parametrize("case", ["narrow", "ties"])
def test_candidates_reduce_to_plain_topk(case, k, mask_self, request):
    """K1's own plain version (per-stripe candidates, the kernel's exact
    output layout) reduced by pass 2 equals the full-sort plain top-k:
    the two-pass design is exact, ties included."""
    c, d = request.getfixturevalue(case)
    tc, td = factor_from_arrays(c, d, "cpu")
    cv, cc = ck.topk_twopass_candidates_plain(tc, td, k, mask_self)
    n = tc.shape[0]
    n_stripes = -(-(-(-n // ck.TILE))
                  // ck.twopass_stripe_tiles(n, tc.shape[1], k, "cpu"))
    assert n_stripes > 1
    assert tuple(cv.shape) == (n, n_stripes, k)
    assert cc.dtype == torch.int32
    fv, fc = tsp.chunked_row_topk(cv.view(n, -1), cc.view(n, -1), k)
    pv, pc = ck.fused_topk_twopass_plain(tc, td, k=k, mask_self=mask_self)
    assert torch.equal(fv, pv) and torch.equal(fc.long(), pc)
