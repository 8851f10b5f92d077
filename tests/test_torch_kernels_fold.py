"""Port parity of K4 (the single-pass top-k for any k): the plain version
behind ``cuda_kernels.fused_topk`` against the JAX package's Pallas
``fused_topk`` and ``fused_topk_ktiled`` in interpret mode, bit for bit
(integer factors below 2^24: the tolerance is zero).

Where a row has fewer than k finite scores the two differ by design, and
only the finite slots are compared there: the Pallas fold repeats an
index in its -inf slots (once a slot is taken its value becomes -inf and
the next round can take the same position again), while K4 gives
distinct ascending -inf columns, as K1 does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import kernel_case


def _assert_fold_matches_pallas(c, d, k, mask_self, ktiled=False):
    fold = pk.fused_topk_ktiled if ktiled else pk.fused_topk
    jv, ji = fold(jnp.asarray(c), jnp.asarray(d), k=k, mask_self=mask_self,
                  interpret=True)
    tc, td = factor_from_arrays(c, d, "cpu")
    tv, ti = ck.fused_topk(tc, td, k=k, mask_self=mask_self)
    assert tv.shape == ti.shape == (c.shape[0], k)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("k", [1, 10, 16, 17, 40])
def test_fold_narrow_matches_pallas(k):
    _assert_fold_matches_pallas(*kernel_case("narrow"), k, mask_self=True)


def test_fold_mask_self_off_matches_pallas():
    _assert_fold_matches_pallas(*kernel_case("narrow"), 20, mask_self=False)


def test_fold_ties_and_zero_degree_match_pallas():
    """Tie-heavy rows (40 distinct patterns) and zero-degree targets:
    the order among equal scores is the lowest column first."""
    _assert_fold_matches_pallas(*kernel_case("ties"), 17, mask_self=True)


def test_fold_ktiled_matches_pallas():
    """V = 1100 > 512: the K-tiled Pallas fold against K4's V loop."""
    c, d = kernel_case("wide")
    assert c.shape[1] > 512
    _assert_fold_matches_pallas(c, d, 17, mask_self=True, ktiled=True)


def test_fold_short_rows_compare_finite_slots():
    """k beyond a row's finite scores: the finite slots agree; K4's -inf
    slots hold distinct columns, ascending, the self column first."""
    rng = np.random.default_rng(2)
    c = rng.integers(0, 3, (30, 8)).astype(np.float32)
    d = (c.astype(np.float64) @ c.sum(0)).astype(np.float32)
    jv, ji = pk.fused_topk(jnp.asarray(c), jnp.asarray(d), k=40,
                           interpret=True)
    tv, ti = ck.fused_topk(*factor_from_arrays(c, d, "cpu"), k=40)
    fin = np.isfinite(np.asarray(jv))
    assert fin.sum(axis=1).tolist() == [29] * 30
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji)[fin], ti.numpy()[fin])
    for r in (0, 17, 29):
        tail = ti[r, 29:].tolist()
        assert tail == [r] + list(range(30, 40))


def test_fold_wrapper_contract():
    tc, td = factor_from_arrays(*kernel_case("ties"), "cpu")
    with pytest.raises(ValueError, match="k >= 1"):
        ck.fused_topk(tc, td, k=0)
    with pytest.raises(TypeError):  # float64 runs; mixed dtypes refuse
        ck.fused_topk(tc.double(), td, k=3)
    # on the CPU the wrapper is the plain version
    v, i = ck.fused_topk(tc, td, k=25, mask_self=False)
    pv, pi = ck.fused_topk_plain(tc, td, k=25, mask_self=False)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    # and its first 16 slots are K1's
    v1, i1 = ck.fused_topk_twopass(tc, td, k=16, mask_self=False)
    assert torch.equal(v[:, :16], v1) and torch.equal(i[:, :16], i1)
