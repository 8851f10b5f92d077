"""The exact instances of K1 and K4 (exact counts past 2^24) on the card
against their plain versions in float64, zero tolerance: factors whose
counts pass 2^24 with 1-, 2- and 3-limb rows (narrow pairs in the s32
accumulator, wide pairs through the f64 fold, kept exact), one wide row
block among narrow ones, K4's lists in shared memory and in the output,
the count of f64 scorings, and the dense backend's rank-all on the card
against the same backend on the CPU. These tests need a CUDA card
(marker ``cuda``) and skip without one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_exact.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.encode import (
    AdjacencyBlock,
    EncodedHIN,
    TypeIndex,
)
from distributed_pathsim_tpu_torch.data.schema import HINSchema
from distributed_pathsim_tpu_torch.driver import PathSimDriver
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


def _past24(n=1000, v=96, seed=3, three_limb=True, wide_block=None):
    """A factor whose counts pass 2^24: small random counts, 40 rows with
    entries of 300-3000 in a few shared columns (their M pass 2^24: 2-limb
    rows), three 3-limb rows when ``three_limb`` (pairs that fail the s32
    bound, folded through f64), and groups of equal rows, whose scores tie.
    ``wide_block``: the row block the 3-limb rows are moved into. Returns
    (c f32, d exact f64), on the CPU."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, v)).astype(np.float64)
    c[rng.random((n, v)) < 0.5] = 0
    big = rng.choice(n, 40, replace=False)
    hot = rng.choice(v, 4, replace=False)
    c[np.ix_(big, hot)] = rng.integers(300, 3000, (40, 4))
    for g in range(6):  # six groups of five equal rows
        rows = rng.choice(n, 5, replace=False)
        c[rows] = c[rows[0]]
    if three_limb:
        for i, r in enumerate(rng.choice(n, 3, replace=False)):
            c[r, hot[i]] = 70000 + 13 * i
    if wide_block is not None:
        three = c.max(1) >= 65536
        rest = np.flatnonzero(~three)
        at = 128 * wide_block
        c = c[np.concatenate([rest[:at], np.flatnonzero(three), rest[at:]])]
    d = c @ c.sum(0)
    assert (c @ c.T).max() >= 2**24 and d.max() < 2**52
    return (torch.tensor(c, dtype=torch.float32),
            torch.tensor(d, dtype=torch.float64))


@pytest.mark.parametrize("instance", ["wide", "narrow"])
def test_exact_twopass_equals_plain(card, instance):
    """K1's exact instance (k 1/10/16, default and 1-tile stripes) and K1
    + pass 2, on the instance with the f64 fold and on the other."""
    c, d = (t.to(card) for t in _past24(three_limb=instance == "wide"))
    lim = ck.split_limbs(c)
    assert bool(lim.host_wide.any()) == (instance == "wide")
    for k in (1, 10, 16):
        for stripe_tiles in (ck.twopass_stripe_tiles(
                c.shape[0], c.shape[1], k, card, exact=True), 1):
            cv, cc = ck.topk_twopass_candidates_exact(
                c, d, k, True, limbs=lim, stripe_tiles=stripe_tiles)
            pv, pc = ck.topk_twopass_candidates_plain(
                c.double(), d, k, True, stripe_tiles=stripe_tiles)
            assert cv.dtype == torch.float64
            assert torch.equal(cv, pv) and torch.equal(cc, pc)
        for mask_self in (True, False):
            fv, fc = ck.fused_topk_twopass_exact(c, d, k=k, limbs=lim,
                                                 mask_self=mask_self)
            gv, gc = ck.fused_topk_twopass_plain(c.double(), d, k=k,
                                                 mask_self=mask_self)
            assert torch.equal(fv, gv) and torch.equal(fc, gc)


@pytest.mark.parametrize("k", [20, 91, 92, 200])
def test_exact_fold_equals_plain(card, k):
    """K4's exact instance: lists in shared memory up to k = 91, in the
    output past it; both self masks."""
    c, d = (t.to(card) for t in _past24())
    for mask_self in (True, False):
        fv, fc = ck.fused_topk_exact(c, d, k=k, mask_self=mask_self)
        gv, gc = ck.fused_topk_plain(c.double(), d, k=k, mask_self=mask_self)
        assert torch.equal(fv, gv) and torch.equal(fc, gc)


def test_one_wide_block_and_the_count_of_f64_scorings(card):
    """The 3-limb rows in row block 2 of 8: that block runs the exact
    instance with the f64 fold beside the other seven; the launches are
    counted under the exact instances' own names, and the count of f64
    scorings is at least the rows' first subtile and at most every
    pair."""
    c, d = (t.to(card) for t in _past24(wide_block=2))
    lim = ck.split_limbs(c)
    assert lim.host_wide.tolist() == [b == 2 for b in range(8)]
    ck.reset_launches()
    scored = torch.zeros(1, dtype=torch.int64, device=card)
    cv, cc = ck.topk_twopass_candidates_exact(c, d, 10, True, limbs=lim,
                                              scored=scored)
    pv, pc = ck.topk_twopass_candidates_plain(
        c.double(), d, 10, True,
        stripe_tiles=ck.twopass_stripe_tiles(1000, 96, 10, card, exact=True))
    assert torch.equal(cv, pv) and torch.equal(cc, pc)
    n_st = cv.shape[1]
    assert 1000 * 64 * n_st <= int(scored) <= 1000 * 1024
    fv, fc = ck.fused_topk_exact(c, d, k=20, limbs=lim)
    gv, gc = ck.fused_topk_plain(c.double(), d, k=20)
    assert torch.equal(fv, gv) and torch.equal(fc, gc)
    assert ck.LAUNCHES == {"topk_twopass_candidates": 0, "fused_scores": 0,
                           "topk_rect_candidates": 0, "topk_fold": 0,
                           "topk_twopass_exact": 1, "topk_fold_exact": 1}
    assert ck.WIDE_ROW_BLOCKS["topk_twopass_exact"] == 1


def _hin(c: np.ndarray) -> EncodedHIN:
    """A graph whose APVPA half factor is ``c``: each (author, venue)
    count its own single-author papers."""
    a, v = np.nonzero(c)
    reps = c[a, v].astype(np.int64)
    n_p = int(reps.sum())
    sizes = {"author": c.shape[0], "paper": n_p, "venue": c.shape[1]}
    blocks = {
        "author_of": AdjacencyBlock("author_of", "author", "paper",
                                    np.repeat(a, reps).astype(np.int32),
                                    np.arange(n_p, dtype=np.int32),
                                    (c.shape[0], n_p)),
        "submit_at": AdjacencyBlock("submit_at", "paper", "venue",
                                    np.arange(n_p, dtype=np.int32),
                                    np.repeat(v, reps).astype(np.int32),
                                    (n_p, c.shape[1])),
    }
    rels = {"author_of": ("author", "paper"), "submit_at": ("paper", "venue")}
    return EncodedHIN(HINSchema(tuple(sizes), rels),
                      {t: TypeIndex(t, (), (), {}, size_override=s)
                       for t, s in sizes.items()}, blocks, name="exact")


@pytest.mark.parametrize("k", [10, 20])
def test_backend_exact_rank_all_on_the_card_equals_the_cpu(card, k):
    """The dense backend past 2^24 ranks on the exact instances on the
    card (K1 + pass 2 at k = 10, K4 at 20), bit for bit the CPU's plain
    versions."""
    c, _ = _past24(n=700, v=24, three_limb=False)
    hin = _hin(c.numpy().astype(np.int64))
    mp = compile_metapath("APVPA", hin.schema)
    ck.reset_launches()
    got = PathSimDriver(create_backend("torch", hin, mp)).rank_all(k)
    want = PathSimDriver(create_backend("torch", hin, mp,
                                        device="cpu")).rank_all(k)
    assert got[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    kernel = "topk_twopass_exact" if k <= 16 else "topk_fold_exact"
    assert ck.LAUNCHES == {name: int(name == kernel) for name in ck.KERNELS}
