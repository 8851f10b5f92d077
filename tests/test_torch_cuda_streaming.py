"""The streaming tier's CUDA kernels on the card against their plain
versions, zero tolerance: K3 (topk_rect_candidates, the row tile against
every column) and K4 (topk_fold, the single-pass top-k for any k), and a
torch-sparse rank-all whose row tiles are counted K3 launches. These
tests need a CUDA card (marker ``cuda``) and skip without one; they
import only the port, so they run on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_streaming.py
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


@pytest.mark.parametrize(
    "spec,n,r0,t,k,stripe_tiles",
    [("APVPA", 1031, 0, 1031, 10, 64),   # all rows, one stripe
     ("APVPA", 1031, 200, 389, 1, 2),    # odd row tile, 5 stripes
     ("APA", 517, 130, 257, 15, 1)],     # wide V (the V loop), k = 15
)
def test_rect_kernel_equals_plain(card, spec, n, r0, t, k, stripe_tiles):
    c, d = _factor(spec, n, card)
    ids = torch.arange(n, dtype=torch.int32, device=card)
    args = (c[r0:r0 + t], c, d[r0:r0 + t], d, ids[r0:r0 + t], k)
    n_true = n - 3  # the last three columns are padding
    cv, cc = ck.topk_rect_candidates(*args, n_true, stripe_tiles)
    pv, pc = ck.topk_rect_candidates_plain(*args, n_true, stripe_tiles)
    assert torch.equal(cv, pv) and torch.equal(cc, pc)
    fv, fc = ck.fused_topk_twopass_rect(*args, n_true_cols=n_true)
    gv, gc = ck.fused_topk_twopass_rect_plain(*args, n_true_cols=n_true)
    assert torch.equal(fv, gv) and torch.equal(fc, gc)


@pytest.mark.parametrize(
    "spec,n,k,mask_self",
    [("APVPA", 1031, 17, True), ("APVPA", 1031, 40, False),
     ("APA", 517, 1, True), ("APVPA", 90, 200, True)],  # k > n: -inf slots
)
def test_fold_kernel_equals_plain(card, spec, n, k, mask_self):
    c, d = _factor(spec, n, card)
    fv, fc = ck.fused_topk(c, d, k=k, mask_self=mask_self)
    gv, gc = ck.fused_topk_plain(c, d, k=k, mask_self=mask_self)
    assert torch.equal(fv, gv) and torch.equal(fc, gc)


def test_sparse_tier_counts_rect_launches(card, tmp_path):
    hin = synthetic_hin(1500, 2250, 20, seed=9)
    mp = compile_metapath("APVPA", hin.schema)
    b = create_backend("torch-sparse", hin, mp, tile_rows=512)
    ck.reset_launches()
    vals, idxs = b.topk_scores(k=10, checkpoint_dir=str(tmp_path))
    assert ck.LAUNCHES["topk_rect_candidates"] == 3  # one per row tile
    assert b._run_config(10)["compute_path"] == "rect"
    cpu = create_backend("torch-sparse", hin, mp, tile_rows=512,
                         device="cpu", rect_kernel=True)
    cv, ci = cpu.topk_scores(k=10)
    np.testing.assert_array_equal(vals, cv)
    np.testing.assert_array_equal(idxs, ci)
