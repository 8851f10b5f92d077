"""K1 at one stripe a row block on the card: at 65,536 rows (512 row
blocks) the default width is the whole factor, and K1 + pass 2 there
equal K1 + pass 2 at 128-tile stripes bit for bit, values and columns,
on the approx instance and on the exact one, with a Zipf head (3-limb
rows in one row block, on the instance with the f64 fold) and groups of
equal rows whose scores tie. ``TWOPASS_STRIPES`` reads one stripe a
launch, and the exact instance scores fewer elements in f64 at one
stripe. Sampled rows of both instances equal the plain version's
scores of the exact counts. These tests need a CUDA card (marker ``cuda``) and skip without
one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_twopass_fill.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda

N, V, K = 65536, 64, 10


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def factor(card):
    """Small random counts with a Zipf head: 64 rows of 300-3000 in four
    shared columns (2-limb rows, counts past 2^24) and three rows of
    about 70,000 (3-limb) in row block 5; 200 groups of four equal rows
    scattered over all columns. Returns (c f32, d exact f64, d f32, the
    limbs) on the card."""
    rng = np.random.default_rng(26)
    c = rng.integers(0, 4, (N, V)).astype(np.float64)
    c[rng.random((N, V)) < 0.6] = 0
    hot = rng.choice(V, 4, replace=False)
    head = rng.choice(N, 64, replace=False)
    c[np.ix_(head, hot)] = rng.integers(300, 3000, (64, 4))
    for g in range(200):
        rows = rng.choice(N, 4, replace=False)
        c[rows] = c[rows[0]]
    for i in range(3):
        c[5 * ck.TILE + 7 * i, hot[i]] = 70000 + 13 * i
    d = c @ c.sum(0)
    assert d.max() >= 2**24 and d.max() < 2**52
    ct = torch.tensor(c, dtype=torch.float32, device=card)
    d64 = torch.tensor(d, dtype=torch.float64, device=card)
    lim = ck.split_limbs(ct)
    assert lim.host_wide.tolist() == [b == 5 for b in range(N // ck.TILE)]
    return ct, d64, d64.to(torch.float32), lim


@pytest.mark.parametrize("instance", ["approx", "exact"])
def test_one_stripe_equals_128_tiles(card, factor, instance):
    c, d64, d32, lim = factor
    exact = instance == "exact"
    name = "topk_twopass_exact" if exact else "topk_twopass_candidates"
    assert ck.twopass_stripe_tiles(N, V, K, card, exact=exact) == N // ck.TILE
    if exact:
        def run(**kw):
            return ck.fused_topk_twopass_exact(c, d64, k=K, limbs=lim, **kw)
    else:
        def run(**kw):
            return ck.fused_topk_twopass(c, d32, k=K, limbs=lim, **kw)
    ck.reset_launches()
    fv, fc = run()
    assert ck.LAUNCHES[name] == 1 and ck.TWOPASS_STRIPES[name] == 1
    assert ck.WIDE_ROW_BLOCKS[name] == 1
    gv, gc = run(stripe_tiles=128)
    assert ck.LAUNCHES[name] == 2 and ck.TWOPASS_STRIPES[name] == 1 + 4
    assert torch.equal(fv, gv) and torch.equal(fc, gc)
    # some row's top-k holds a tie across the 128-tile stripes' bounds
    width = 128 * ck.TILE
    same = fv[:, 1:] == fv[:, :-1]
    apart = (fc[:, 1:] // width) != (fc[:, :-1] // width)
    assert bool((same & apart).any())
    # sampled rows (the first, the Zipf head's wide block, the middle,
    # the last) against the plain version's scores of the exact counts:
    # f64 for the exact instance, M rounded to f32 over f32 row sums for
    # the approx one (K2's plain check in test_torch_cuda_limbs.py)
    rows = torch.tensor([0, 5 * ck.TILE, 5 * ck.TILE + 7, N // 2, N - 1],
                        device=card)
    cd = c.double()
    m = cd[rows] @ cd.T
    if exact:
        den = d64[rows, None] + d64[None, :]
        s = torch.where(den > 0, 2.0 * m / den, 0.0)
    else:
        den = d32[rows, None] + d32[None, :]
        s = torch.where(den > 0, (2.0 * m.float()) / den, 0.0)
    s[torch.arange(rows.numel(), device=card), rows] = float("-inf")
    pv, pc = torch.sort(s, dim=1, descending=True, stable=True)
    assert torch.equal(fv[rows], pv[:, :K])
    assert torch.equal(fc[rows], pc[:, :K])

def test_exact_scores_fewer_at_one_stripe(card, factor):
    """Each stripe scores a row's first subtile in full while its list
    fills: one stripe leaves fewer f64 scorings than four."""
    c, d64, _, lim = factor
    counts = {}
    for tiles in (N // ck.TILE, 128):
        scored = torch.zeros(1, dtype=torch.int64, device=card)
        ck.topk_twopass_candidates_exact(c, d64, K, True, limbs=lim,
                                         stripe_tiles=tiles, scored=scored)
        counts[tiles] = int(scored)
    assert N * ck.SUBTILE <= counts[N // ck.TILE] < counts[128]
