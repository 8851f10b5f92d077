"""The autotuner on the card: a table written by ``tune`` keyed with the
card's name (the kernel knobs measured through K1 and K3, no plain
version on the card), K1 and K3 at every width the kernel knobs can
hand them equal to their plain versions, and a rank-all under the
tuned table equal to the untuned one. These tests need a CUDA card
(marker ``cuda``) and skip without one; they import only the port:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_tune.py
"""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.tuning import autotuner as at

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ck.true_f32()
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_tuning():
    tuning.reset()
    yield
    tuning.reset()


def _factor(card, n=3000, v=48, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, (n, v)).astype(np.float32)
    c[rng.random(n) < 0.05] = 0.0
    ct = torch.tensor(c, device=card)
    return ct, ct @ ct.sum(0)


def test_table_written_on_the_card(card, tmp_path):
    """``tune`` on the card: entries keyed with the card's name for both
    kernel knobs, chosen among their candidates, and K1 and K3 launched
    while it ran."""
    tuning.set_device(card)
    ck.reset_launches()
    out = tmp_path / "t.json"
    table = at.tune([at.SweepPoint(8192, 64),
                     at.SweepPoint(16384, 64, nnz=81920)],
                    knobs=["twopass_stripe_tiles", "rect_target_units",
                           "ring_kernel"],
                    reps=1, out=str(out), device=card)
    assert ck.LAUNCHES["topk_twopass_candidates"] > 0
    assert ck.LAUNCHES["topk_rect_candidates"] > 0
    loaded = tuning.load_table(str(out), torch.cuda.get_device_name(card))
    assert loaded.digest == table.digest
    name = tuning.table.normalize_device(torch.cuda.get_device_name(card))
    knobs = {}
    for key, ent in loaded.entries.items():
        knob, dev = key.split("|")[:2]
        assert dev == name
        knobs[knob] = ent.choice
    assert knobs["twopass_stripe_tiles"] in \
        tuning.KNOBS["twopass_stripe_tiles"].candidates({})
    assert knobs["rect_target_units"] in \
        tuning.KNOBS["rect_target_units"].candidates({})
    assert knobs["ring_kernel"] == "rect-cuda"


def test_kernels_at_every_candidate_width(card):
    """K1 and K3 equal their plain versions at every width the two
    kernel knobs can hand them."""
    c, d = _factor(card)
    n = c.shape[0]
    lim = ck.split_limbs(c)
    for w in tuning.KNOBS["twopass_stripe_tiles"].candidates({}):
        got = ck.topk_twopass_candidates(c, d, 10, True, limbs=lim,
                                         stripe_tiles=w)
        want = ck.topk_twopass_candidates_plain(c, d, 10, True,
                                                stripe_tiles=w)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), w
    ids = torch.arange(n, dtype=torch.int32, device=card)
    for u in tuning.KNOBS["rect_target_units"].candidates({}):
        w = ck._stripe_tiles_for_units(n, n, u)
        args = (c, c, d, d, ids, 10, n - 7)
        got = ck.topk_rect_candidates(*args, stripe_tiles=w,
                                      limbs=(lim, lim))
        want = ck.topk_rect_candidates_plain(*args, stripe_tiles=w)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (u, w)


def test_tuned_rank_all_equals_untuned(card):
    """A rank-all under a table that sets K1's width and K3's target
    (the dense K1 path and torch-sparse's K3 sweep) returns the untuned
    arrays."""
    hin = synthetic_hin(6000, 9000, 64, seed=5)
    mp = compile_metapath("APVPA", hin.schema)
    dense = create_backend("torch", hin, mp, device=card)
    sparse = create_backend("torch-sparse", hin, mp, device=card,
                            tile_rows=2048)
    want = [b.topk(k=10) if b is dense else b.topk_scores(k=10)
            for b in (dense, sparse)]
    v = dense._half()[0].shape[1]
    table = tuning.TuningTable(torch.cuda.get_device_name(card))
    dev = torch.cuda.get_device_name(card)
    table.put(tuning.make_key("twopass_stripe_tiles", dev, n=6000, v=v), 8)
    table.put(tuning.make_key("rect_target_units", dev, n=6144, v=v), 2048)
    tuning.set_table(table, "test")
    hits0 = tuning.lookup_stats().get("hit", 0)
    got = [dense.topk(k=10), sparse.topk_scores(k=10)]
    assert tuning.lookup_stats().get("hit", 0) > hits0
    for (gv, gi), (wv, wi) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gi, wi)
