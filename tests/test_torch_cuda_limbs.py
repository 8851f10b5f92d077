"""The kernels on the int8 tensor cores, on the card, against their plain
versions with zero tolerance: factors with 1-, 2- and 3-limb rows
(narrow tile pairs summed in one s32 accumulator, and pairs folded
through f64 in each kernel's wide instance) for all four kernels, K1
and K4 on a factor whose one wide row block sits among narrow ones, K4
past the k its lists keep in shared memory, limbs split on the card
once and handed over, and a CUDA factor that is not integer path counts
raising.
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


def _multilimb(device, n=700, v=96, seed=3, three_limb=3):
    """Rows of 1, 2 and 3 limbs; path counts between distinct rows below
    2^24 (a big entry's column holds at most 1 elsewhere). The 3-limb
    rows' tile pairs fail the s32 bound (65536^2 · 96 >= 2^31) and fold
    through f64 (the kernels' wide instances); the 2-limb ones sum in
    one s32 accumulator. ``three_limb=0`` leaves 1- and 2-limb rows
    only, whose row sums bound every count below 2^31: the narrow
    instances."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, v)).astype(np.float64)
    c[rng.random((n, v)) < 0.4] = 0
    cols = rng.choice(v, 10, replace=False)
    c[:, cols] = np.minimum(c[:, cols], 1)
    for i, (r, col) in enumerate(zip(rng.choice(n, 10, replace=False), cols)):
        c[r, col] = 70000 + 13 * i if i < three_limb else 257 + 90 * i
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


@pytest.mark.parametrize("instance", ["wide", "narrow"])
def test_twopass_and_scores_multilimb_equal_plain(card, instance):
    """K1 (k in 1/10/16, self masked, default and 1-tile stripes) and K2
    on multi-limb factors, in each kernel instance. K2 also equals the
    correctly rounded scores of the exact counts on the diagonal, where
    a 3-limb row's own count passes 2^24."""
    c, d = _multilimb(card, three_limb=3 if instance == "wide" else 0)
    lim = ck.split_limbs(c)
    assert ck._needs_wide(lim, lim) == (instance == "wide")
    assert int(lim.counts.max()) == (3 if instance == "wide" else 2)
    for k in (1, 10, 16):
        for stripe_tiles in (None, 1):
            cv, cc = ck.topk_twopass_candidates(c, d, k, True, limbs=lim,
                                                stripe_tiles=stripe_tiles)
            pv, pc = ck.topk_twopass_candidates_plain(
                c, d, k, True, stripe_tiles=stripe_tiles)
            assert torch.equal(cv, pv) and torch.equal(cc, pc)
        fv, fc = ck.fused_topk_twopass(c, d, k=k, limbs=lim)
        gv, gc = ck.fused_topk_twopass_plain(c, d, k=k)
        assert torch.equal(fv, gv) and torch.equal(fc, gc)
    got = ck.fused_scores(c, d, limbs=lim)
    m = c.double() @ c.double().T
    den = d[:, None] + d[None, :]
    assert torch.equal(got, torch.where(den > 0, (2.0 * m.float()) / den, 0.0))
    exact = m < 2**24
    assert torch.equal(got[exact], ck.fused_scores_plain(c, d)[exact])


def _one_wide_block(device):
    """``_multilimb``'s 1000 rows reordered so that its three 3-limb rows
    are rows 300-302: row block 2 of 8 is the one whose row sums leave M
    unbounded below 2^31, as the Zipf head's block is in a rank-all."""
    c, d = _multilimb("cpu", n=1000)
    three = c.amax(1) >= 65536
    rest = (~three).nonzero().flatten()
    perm = torch.cat([rest[:300], three.nonzero().flatten(), rest[300:]])
    return c[perm].to(device), d[perm].to(device)


def test_one_wide_row_block_among_narrow_equals_plain(card):
    """K1 and K4 launch the wide block on the instance with the f64 fold
    beside the narrow launch of the other seven: values and columns equal
    the plain versions bit for bit (ties included), WIDE_ROW_BLOCKS
    counts the one wide block a call and LAUNCHES one launch a call."""
    c, d = _one_wide_block(card)
    lim = ck.split_limbs(c)
    assert lim.host_wide.tolist() == [b == 2 for b in range(8)]
    assert ck._needs_wide(lim, lim)  # the whole factor's test: wide
    ck.reset_launches()
    for k in (1, 10, 16):
        fv, fc = ck.fused_topk_twopass(c, d, k=k, limbs=lim)
        gv, gc = ck.fused_topk_twopass_plain(c, d, k=k)
        assert torch.equal(fv, gv) and torch.equal(fc, gc)
    cv, cc = ck.topk_twopass_candidates(c, d, 10, True, limbs=lim,
                                        stripe_tiles=1)
    pv, pc = ck.topk_twopass_candidates_plain(c, d, 10, True, stripe_tiles=1)
    assert torch.equal(cv, pv) and torch.equal(cc, pc)
    for k in (20, ck.FOLD_SMEM_K_MAX + 1):
        fv, fc = ck.fused_topk(c, d, k=k, limbs=lim)
        gv, gc = ck.fused_topk_plain(c, d, k=k)
        assert torch.equal(fv, gv) and torch.equal(fc, gc)
    assert ck.LAUNCHES == {"topk_twopass_candidates": 4, "fused_scores": 0,
                           "topk_rect_candidates": 0, "topk_fold": 2,
                           "topk_twopass_exact": 0, "topk_fold_exact": 0}
    assert ck.WIDE_ROW_BLOCKS == {"topk_twopass_candidates": 4,
                                  "fused_scores": 0,
                                  "topk_rect_candidates": 0, "topk_fold": 2,
                                  "topk_twopass_exact": 0,
                                  "topk_fold_exact": 0}


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
    """The split made once (kernel_limbs and rect_pad_factor, the
    backends' path) and a row tile's slice of it give what the wrappers'
    own split gives, for every kernel."""
    c, d = _multilimb(card)
    cc, dc, limbs = ck.rect_pad_factor(c, d, ck.kernel_limbs(c))
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
    got = ck.topk_twopass_candidates(c, d, 10, True, limbs=limbs)
    want = ck.topk_twopass_candidates(c, d, 10, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(ck.fused_scores(c, d, limbs=limbs),
                       ck.fused_scores(c, d))


def test_non_count_factor_raises_on_card(card):
    """Every kernel's split refuses a factor that is not integer path
    counts in [0, 2^24)."""
    d = torch.ones(40, device=card)
    ids = torch.arange(40, dtype=torch.int32, device=card)
    for bad in (0.5, -2.0, float(2**24)):
        c = torch.ones((40, 8), device=card)
        c[3, 2] = bad
        for call in (lambda: ck.fused_topk(c, d, k=3),
                     lambda: ck.topk_rect_candidates(c, c, d, d, ids, 3),
                     lambda: ck.fused_topk_twopass(c, d, k=3),
                     lambda: ck.fused_scores(c, d)):
            with pytest.raises(ValueError):
                call()
