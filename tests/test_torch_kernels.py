"""Port parity: the plain versions of the CUDA kernels
(distributed_pathsim_tpu_torch/ops/cuda_kernels.py) against the JAX
package's Pallas kernels in interpret mode — bit for bit, values and
indices (path counts are integers below 2^24: every f32 sum is exact in
any order and the one division is correctly rounded, so the tolerance
is zero). Mirrors tests/test_pallas.py's twopass cases; the tie cases
are in test_torch_kernels_ties.py, the scores cases in
test_torch_kernels_scores.py."""

import jax.numpy as jnp
import pytest

from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import assert_topk_matches_pallas, kernel_case


@pytest.fixture(scope="module")
def narrow():
    return kernel_case("narrow")


@pytest.fixture(scope="module")
def wide():
    return kernel_case("wide")


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("mask_self", [True, False])
def test_twopass_narrow_matches_pallas(narrow, k, mask_self):
    assert_topk_matches_pallas(*narrow, k, mask_self)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_twopass_wide_matches_pallas(wide, k):
    c, d = wide
    assert c.shape[1] > 512
    assert_topk_matches_pallas(c, d, k, mask_self=True)


def test_k_above_candidate_bound_raises(narrow):
    c, d = narrow
    with pytest.raises(ValueError, match="k <= 16"):
        pk.fused_topk_twopass(jnp.asarray(c), jnp.asarray(d), k=17,
                              interpret=True)
    tc, td = factor_from_arrays(c, d, "cpu")
    with pytest.raises(ValueError, match="k <= 16"):
        ck.fused_topk_twopass(tc, td, k=17)
