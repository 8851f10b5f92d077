"""K1's untuned stripe width fills the card and no more: stripes only as
narrow as gives about ``RECT_TARGET_UNITS`` (row block, stripe) units, so
from 512 row blocks on a row keeps one list over all columns. Its
candidate buffer is then N · k slots, the budget passes at every N a dense
factor holds, and K1 + pass 2 give the same top-k at one stripe as at
many, exact score ties across stripe bounds included (the plain version,
the kernel's exact output)."""

import pytest
import torch

from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import sparse as tsp


@pytest.mark.parametrize("n,tiles", [(8192, 8), (32768, 128), (49152, 192),
                                     (65536, 512), (1 << 20, 8192)])
def test_default_width_fills_the_card(n, tiles):
    """8 and 128 tiles below 256 row blocks, as before; wider from there
    to 512 row blocks (about 512 units); the whole width past it."""
    assert ck.default_twopass_stripe_tiles(n) == tiles
    assert ck.twopass_stripe_tiles(n, 64, 10, "cpu") == tiles
    n_units = -(-n // ck.TILE) * ck._rect_n_stripes(n, tiles)
    assert n_units >= ck.RECT_TARGET_UNITS


def test_candidate_bytes_one_stripe_at_a_million():
    n = 1 << 20
    assert ck._rect_n_stripes(n, ck.twopass_stripe_tiles(n, 64, 10, "cpu")) \
        == 1
    assert ck.candidate_bytes(n, 10, 64, "cpu") == n * 10 * 8
    assert ck.candidate_bytes(n, 10, 64, "cpu", exact=True) == n * 10 * 12


def test_twopass_fits_at_two_million_on_a_card(monkeypatch):
    """On an 80 GB card (budget 10^10 bytes) K1's one-stripe buffer at 2M
    rows takes 2M · 16 · 12 bytes at most: the dense rank-all stays on
    K1."""

    class Card:
        total_memory = 80 * 10**9

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Card)
    n = 2 * 10**6
    for k in (10, 16):
        assert ck.twopass_fits(n, k, "cuda", 64)
        assert ck.twopass_fits(n, k, "cuda", 64, exact=True)
    assert ck.candidate_bytes(n, 16, 64, "cuda", exact=True) == n * 16 * 12


def _tied_factor(n: int, groups: int, seed: int):
    """Integer counts whose rows repeat in ``groups`` classes scattered
    over all columns, and the row sums of M = C Cᵀ: a class's members
    score exactly equal against every row, across stripe bounds."""
    g = torch.Generator().manual_seed(seed)
    patterns = torch.randint(0, 4, (groups, 24), generator=g).float()
    member = torch.randint(0, groups, (n,), generator=g)
    c = patterns[member]
    return c, c @ c.sum(0)


@pytest.mark.parametrize("stripes", [2, 8, 64])
def test_one_stripe_equals_many(stripes):
    """K1's plain candidates reduced by pass 2 (as the card reduces them)
    at one stripe of 64 tiles and at ``stripes`` stripes: equal bit for
    bit, values and columns, f32 and f64, both self masks; and equal to
    the one full sort."""
    n, k = 8192, 10
    c, d = _tied_factor(n, 700, seed=stripes)
    for dtype in (torch.float32, torch.float64):
        cc, dd = c.to(dtype), d.to(dtype)
        for mask_self in (True, False):
            got = []
            for tiles in (64, 64 // stripes):
                cv, ci = ck.topk_twopass_candidates_plain(
                    cc, dd, k, mask_self, stripe_tiles=tiles)
                assert cv.shape[1] == 64 // tiles
                fv, fc = tsp.chunked_row_topk(cv.view(n, -1),
                                              ci.view(n, -1), k)
                got.append((fv, fc.long()))
            (v1, c1), (vm, cm) = got
            assert torch.equal(v1, vm) and torch.equal(c1, cm)
            sv, sc = ck.fused_topk_twopass_plain(cc, dd, k=k,
                                                 mask_self=mask_self)
            assert torch.equal(v1, sv) and torch.equal(c1, sc)
            # ties do straddle stripes: some row's top-k holds two
            # columns of one score in different stripes of the narrow
            # layout
            width = (64 // stripes) * ck.TILE
            same = v1[:, 1:] == v1[:, :-1]
            apart = (c1[:, 1:] // width) != (c1[:, :-1] // width)
            assert bool((same & apart).any())


@pytest.fixture
def untuned():
    from distributed_pathsim_tpu_torch import tuning

    tuning.reset()
    yield tuning
    tuning.reset()


def test_card_table_keeps_the_default_past_its_buckets(untuned):
    """The card's committed table (artifacts/tuning_table_h100.json, K1
    widths measured at 2,048, 8,192 and 32,768 rows) keyed on this host:
    a width from the shape's own bucket holds; a nearest bucket's width
    narrower than the default is a fallback lookup (2²⁰ rows keep one
    stripe), a wider one holds."""
    import json
    import pathlib

    tuning = untuned
    path = pathlib.Path(__file__).resolve().parents[1] / "artifacts" \
        / "tuning_table_h100.json"
    table = tuning.TuningTable("cpu")
    for key, ent in json.loads(path.read_text())["entries"].items():
        if key.startswith("twopass_stripe_tiles|"):
            knob, _, *rest = key.split("|")
            table.put("|".join([knob, "cpu", *rest]), ent["choice"])
    tuning.set_table(table, "test")
    stats = tuning.lookup_stats
    h0, f0 = stats().get("hit", 0), stats().get("fallback", 0)
    assert ck.twopass_stripe_tiles(32768, 384, 10, "cpu") == 128
    assert stats()["hit"] == h0 + 1
    # past 32,768 rows the n15 entry's 128 tiles is the nearest bucket's
    assert ck.twopass_stripe_tiles(49152, 384, 10, "cpu") == 192
    assert ck.twopass_stripe_tiles(1 << 20, 64, 10, "cpu") == 8192
    assert ck.twopass_stripe_tiles(1 << 20, 384, 10, "cpu", exact=True) \
        == 8192
    assert ck.candidate_bytes(1 << 20, 10, 64, "cpu") == (1 << 20) * 10 * 8
    assert stats()["fallback"] == f0 + 4
    # 4,096 rows: default 2 tiles, the nearest bucket's 8 or 16 holds
    assert ck.default_twopass_stripe_tiles(4096) == 2
    assert ck.twopass_stripe_tiles(4096, 384, 10, "cpu") in (8, 16)
    assert stats()["fallback"] == f0 + 4


@pytest.mark.parametrize("n,widths", [
    (8192, [8, 16, 32, 64]),
    (49152, [8, 16, 32, 64, 128, 192, 256, 384]),
    (1 << 20, [128, 256, 8192]),  # narrower ones pass the budget
])
def test_tuner_candidates_hold_the_default(n, widths):
    """The tuner measures K1's untuned width and one stripe besides the
    fixed widths, so a tuned entry can equal the default."""
    from distributed_pathsim_tpu_torch import tuning

    ctx = {"n": n, "v": 64, "k": 10, "budget_bytes": 10**10}
    assert tuning.KNOBS["twopass_stripe_tiles"].candidates(ctx) == widths
    assert ck.default_twopass_stripe_tiles(n) in widths
