"""Port parity of the fused scores kernel (K2) against the Pallas scores
kernels (plain and K-tiled) in interpret mode, bit for bit: its plain
version, and its arithmetic on the int8 tensor cores (the u8 limb
product ``cuda_kernels.limb_product_plain`` followed by the normalize),
on narrow, wide and multi-limb factors; and the wrappers' contract on
the CPU: the plain version runs for CPU tensors, nothing is counted as a
launch, inputs are checked, and the candidate budget is what the
two-pass top-k plans with."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import kernel_case


@pytest.fixture(scope="module")
def narrow():
    return kernel_case("narrow")


@pytest.fixture(scope="module")
def wide():
    return kernel_case("wide")


@pytest.fixture(scope="module")
def ties():
    return kernel_case("ties")


def _limb_scores(tc, td):
    """K2's arithmetic in torch: the exact u8 limb product M, one
    correctly rounded conversion to f32, then the normalize."""
    limbs = ck.split_limbs(tc)
    m = ck.limb_product_plain(limbs, limbs)
    den = td[:, None] + td[None, :]
    return torch.where(den > 0, (2.0 * m) / den, 0.0).numpy()


@pytest.mark.parametrize("case", ["narrow", "wide", "ties"])
def test_scores_match_pallas(case, request):
    c, d = request.getfixturevalue(case)
    tc, td = factor_from_arrays(c, d, "cpu")
    got = ck.fused_scores(tc, td).numpy()
    np.testing.assert_array_equal(got, ck.fused_scores_plain(tc, td).numpy())
    kernel = pk.fused_scores if pk.fits_vmem(c.shape[1]) else pk.fused_scores_ktiled
    want = np.asarray(kernel(jnp.asarray(c), jnp.asarray(d), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_limb_scores(tc, td), want)


def test_limb_scores_multilimb_match_pallas():
    """K2's arithmetic on a factor of 1-, 2- and 3-limb rows equals both
    Pallas scores kernels off the diagonal (counts below 2^24, exact in
    any f32 order); on the diagonal, where a 3-limb row's own count is
    past 2^24, it is the correctly rounded exact score."""
    c, d = kernel_case("multilimb")
    tc, td = factor_from_arrays(c, d, "cpu")
    assert sorted(set(ck.split_limbs(tc).counts.tolist())) == [1, 2, 3]
    got = _limb_scores(tc, td)
    off = ~np.eye(c.shape[0], dtype=bool)
    for kernel in (pk.fused_scores, pk.fused_scores_ktiled):
        want = np.asarray(kernel(jnp.asarray(c), jnp.asarray(d),
                                 interpret=True))
        np.testing.assert_array_equal(got[off], want[off])
    ci = c.astype(np.int64)
    m_ii = np.float32((ci * ci).sum(1))  # exact below 2^53, rounded once
    assert m_ii.max() > 2**24
    np.testing.assert_array_equal(
        np.diag(got), np.where(d > 0, (np.float32(2) * m_ii) / (d + d), 0))


def test_scores_ktiled_matches_on_narrow(narrow):
    c, d = narrow
    tc, td = factor_from_arrays(c, d, "cpu")
    want = np.asarray(pk.fused_scores_ktiled(jnp.asarray(c), jnp.asarray(d),
                                             interpret=True))
    np.testing.assert_array_equal(ck.fused_scores_plain(tc, td).numpy(), want)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing(narrow):
    tc, td = factor_from_arrays(*narrow, "cpu")
    ck.reset_launches()
    ck.fused_topk_twopass(tc, td, k=5)
    ck.fused_scores(tc, td)
    ck.fused_topk(tc, td, k=20)
    ids = torch.arange(tc.shape[0], dtype=torch.int32)
    ck.fused_topk_twopass_rect(tc, tc, td, td, ids, k=5)
    assert ck.LAUNCHES == {"topk_twopass_candidates": 0, "fused_scores": 0,
                           "topk_rect_candidates": 0, "topk_fold": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ck.topk_twopass_candidates(tc, td, 5, True)


def test_input_checks():
    c = torch.zeros((5, 3))
    with pytest.raises(TypeError):
        ck.fused_scores(c.double(), torch.zeros(5, dtype=torch.float64))
    with pytest.raises(ValueError):
        ck.fused_scores(c, torch.zeros(4))
    with pytest.raises(ValueError, match="device"):
        ck.fused_scores(c.to("meta"), torch.zeros(5, device="meta"))


def test_tf32_check(monkeypatch):
    """true_f32 turns TF32 off; check_true_f32 refuses while it is on."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ValueError, match="TF32"):
        ck.check_true_f32()
    ck.true_f32()
    assert not torch.backends.cuda.matmul.allow_tf32
    ck.check_true_f32()


def test_candidate_budget(monkeypatch):
    """The budget is an eighth of the card's memory; the CPU's plain
    version has no candidate buffer, so every shape fits there."""
    # one list of k per row and stripe: 2 stripes of 128 column tiles at
    # the bench shape; narrower stripes below ~64k rows keep the card busy
    assert ck.twopass_stripe_tiles(32768) == ck.TWOPASS_STRIPE_TILES == 128
    assert ck.candidate_bytes(32768, 10) == 32768 * 2 * 10 * 8
    assert ck.twopass_stripe_tiles(8192) == 8
    assert ck.candidate_bytes(8192, 16) == 8192 * 8 * 16 * 8
    assert ck.twopass_fits(1_500_000, 16, "cpu")

    class Card:
        total_memory = 80 * 10**9

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Card)
    assert ck.candidate_budget_bytes("cuda") == 10**10
    assert ck.twopass_fits(32768, 10, "cuda")
    assert ck.twopass_fits(1_400_000, 10, "cuda")
    assert not ck.twopass_fits(1_500_000, 16, "cuda")
