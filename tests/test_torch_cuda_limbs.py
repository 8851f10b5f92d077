"""K3 and K4 on the int8 tensor cores, on the card, against their plain
versions with zero tolerance: a factor with 1-, 2- and 3-limb rows
(narrow tile pairs summed in one s32 accumulator, and pairs folded
through f64), K4 past the k its lists keep in shared memory, limbs split
on the card, and a CUDA factor that is not integer path counts raising.
These tests need a CUDA card (marker ``cuda``) and skip without one;
they import only the port, so they run on a machine with no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_limbs.py
"""

import numpy as np
import pytest
import torch

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


def _multilimb(device, n=700, v=96, seed=3):
    """Rows of 1, 2 and 3 limbs; path counts between distinct rows below
    2^24 (a big entry's column holds at most 1 elsewhere). The 3-limb
    rows' tile pairs fail the s32 bound (65536^2 · 96 >= 2^31) and fold
    through f64; the 2-limb ones sum in one s32 accumulator."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, v)).astype(np.float64)
    c[rng.random((n, v)) < 0.4] = 0
    cols = rng.choice(v, 10, replace=False)
    c[:, cols] = np.minimum(c[:, cols], 1)
    for i, (r, col) in enumerate(zip(rng.choice(n, 10, replace=False), cols)):
        c[r, col] = 70000 + 13 * i if i < 3 else 257 + 90 * i
    m = c @ c.T
    np.fill_diagonal(m, 0)
    assert m.max() < 2**24
    return (torch.tensor(c, dtype=torch.float32, device=device),
            torch.tensor(c @ c.sum(0), dtype=torch.float32, device=device))


def _apvpa(n, device, seed=4):
    hin = synthetic_hin(n, int(n * 1.5), 24, seed=seed)
    c = planner.dense_half(hin, compile_metapath("APVPA", hin.schema),
                           dtype=np.float64)
    return factor_from_arrays(c, c @ c.sum(0), device)


@pytest.mark.parametrize("k,r0,t,stripe_tiles",
                         [(10, 0, 700, None), (15, 133, 301, 1), (1, 0, 64, 2)])
def test_rect_kernel_multilimb_equals_plain(card, k, r0, t, stripe_tiles):
    c, d = _multilimb(card)
    n = c.shape[0]
    assert sorted(set(ck.split_limbs(c).counts.tolist())) == [1, 2, 3]
    ids = torch.arange(n, dtype=torch.int32, device=card)
    args = (c[r0:r0 + t], c, d[r0:r0 + t], d, ids[r0:r0 + t], k, n - 5,
            stripe_tiles)
    cv, cc = ck.topk_rect_candidates(*args)
    pv, pc = ck.topk_rect_candidates_plain(*args)
    assert torch.equal(cv, pv) and torch.equal(cc, pc)


@pytest.mark.parametrize("k", [20, ck.FOLD_SMEM_K_MAX + 1])
def test_fold_kernel_multilimb_equals_plain(card, k):
    """k = 20 keeps the lists in shared memory; one past FOLD_SMEM_K_MAX
    keeps them in the output."""
    c, d = _multilimb(card)
    fv, fc = ck.fused_topk(c, d, k=k, mask_self=True)
    gv, gc = ck.fused_topk_plain(c, d, k=k, mask_self=True)
    assert torch.equal(fv, gv) and torch.equal(fc, gc)


def test_fold_kernel_past_smem_limit_both_masks(card):
    c, d = _apvpa(400, card)
    k = ck.FOLD_SMEM_K_MAX + 40
    for mask_self in (True, False):
        fv, fc = ck.fused_topk(c, d, k=k, mask_self=mask_self)
        gv, gc = ck.fused_topk_plain(c, d, k=k, mask_self=mask_self)
        assert torch.equal(fv, gv) and torch.equal(fc, gc)


def test_presplit_limbs_match(card):
    """The split made once (rect_pad_factor, the backends' path) and a
    row tile's slice of it give what the wrapper's own split gives."""
    c, d = _multilimb(card)
    cc, dc, limbs = ck.rect_pad_factor(c, d)
    lim_cpu = ck.split_limbs(c.cpu())
    assert torch.equal(limbs.planes.cpu(), lim_cpu.planes)
    ids = torch.arange(100, 356, dtype=torch.int32, device=card)
    args = (cc[100:356], cc, dc[100:356], dc, ids, 10, cc.shape[0])
    got = ck.topk_rect_candidates(*args, limbs=(limbs.rows(100, 356), limbs))
    want = ck.topk_rect_candidates(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fv, fc = ck.fused_topk(c, d, k=12, limbs=limbs)
    gv, gc = ck.fused_topk_plain(c, d, k=12)
    assert torch.equal(fv, gv) and torch.equal(fc, gc)


@pytest.mark.parametrize("bad", [0.5, -2.0, float(2**24)])
def test_non_count_factor_raises_on_card(card, bad):
    c = torch.ones((40, 8), device=card)
    c[3, 2] = bad
    d = torch.ones(40, device=card)
    with pytest.raises(ValueError):
        ck.fused_topk(c, d, k=3)
    ids = torch.arange(40, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ck.topk_rect_candidates(c, c, d, d, ids, 3)
