"""Port parity of K1's candidate layout against the JAX package: each
row's top-k per stripe of columns (``cuda_kernels.
topk_twopass_candidates_plain``, the kernel's exact output) reduced by
pass 2 (``ops/sparse.chunked_row_topk``) equals the Pallas
``fused_topk_twopass`` in interpret mode bit for bit, values and indices,
on the narrow, wide (APA: the K-tiled Pallas variant) and tie-heavy
fixtures (the last with zero-degree targets), k in {1, 10, 16}, both
self masks, at the default stripe width and at narrower ones that give
many stripes. Tolerance zero: integer path counts below 2^24 and one
correctly rounded division."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.data.encode import factor_from_arrays
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from torch_port_util import kernel_case


def _check_layout(cv, cc, n, k, width):
    """[N, n_stripes, k]; each stripe's columns inside it, distinct, in
    (descending value, ascending column) order."""
    n_st = -(-(-(-n // ck.TILE) * ck.TILE) // width)
    assert tuple(cv.shape) == tuple(cc.shape) == (n, n_st, k)
    assert cc.dtype == torch.int32 and cv.dtype == torch.float32
    lo = torch.arange(n_st).view(1, n_st, 1) * width
    assert bool(((cc >= lo) & (cc < lo + width)).all())
    assert bool((torch.sort(cc, 2).values.diff(dim=2) > 0).all())
    later = (cv[..., 1:] < cv[..., :-1]) | (
        (cv[..., 1:] == cv[..., :-1]) & (cc[..., 1:] > cc[..., :-1]))
    assert bool(later.all())


@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("case", ["narrow", "wide", "ties"])
def test_stripe_candidates_reduce_to_pallas(case, k):
    c, d = kernel_case(case)
    tc, td = factor_from_arrays(c, d, "cpu")
    n = tc.shape[0]
    for mask_self in (True, False):
        jv, ji = pk.fused_topk_twopass(jnp.asarray(c), jnp.asarray(d), k=k,
                                       mask_self=mask_self, interpret=True)
        for stripe_tiles in (1, 3, 64, None):
            cv, cc = ck.topk_twopass_candidates_plain(
                tc, td, k, mask_self, stripe_tiles=stripe_tiles)
            width = (stripe_tiles or ck.twopass_stripe_tiles(n)) * ck.TILE
            _check_layout(cv, cc, n, k, width)
            fv, fc = tsp.chunked_row_topk(cv.view(n, -1), cc.view(n, -1), k)
            np.testing.assert_array_equal(np.asarray(jv), fv.numpy())
            np.testing.assert_array_equal(np.asarray(ji), fc.long().numpy())
