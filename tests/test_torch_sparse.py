"""Port parity of the host sparse algebra of
distributed_pathsim_tpu_torch/ops/sparse.py against the JAX package's
ops/sparse.py: the two-pass reduction (chunked_row_topk) and the host
COO fold (coo_matmul, COOMatrix.summed, matmul_summed — the JAX
package's _matmul_summed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.ops import sparse as jsp
from distributed_pathsim_tpu_torch.ops import sparse as tsp


@pytest.mark.parametrize(
    "t,w,k,chunk",
    [(9, 37, 5, 512), (7, 1300, 10, 512), (5, 2048, 16, 512),
     (6, 700, 3, 64), (4, 12, 16, 512)],
)
def test_chunked_row_topk_identical(t, w, k, chunk):
    """Tie-heavy integer-valued rows with -inf holes: values and the
    (lowest column) tie order must both match the JAX version."""
    rng = np.random.default_rng(w)
    s = rng.integers(0, 4, (t, w)).astype(np.float32)
    s[rng.random((t, w)) < 0.1] = -np.inf
    cols = np.broadcast_to(np.arange(w, dtype=np.int32) * 3 + 1, (t, w)).copy()
    jv, jc = jsp.chunked_row_topk(jnp.asarray(s), jnp.asarray(cols), k=k,
                                  chunk=chunk)
    tv, tc = tsp.chunked_row_topk(torch.from_numpy(s), torch.from_numpy(cols),
                                  k=k, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


def _random_coo(mod, rng, shape, nnz, signed=False):
    w = rng.integers(1, 3, nnz).astype(np.float64)
    if signed:
        w *= rng.choice([-1.0, 1.0], nnz)
    return mod.COOMatrix(
        rows=rng.integers(0, shape[0], nnz).astype(np.int64),
        cols=rng.integers(0, shape[1], nnz).astype(np.int64),
        weights=w, shape=shape,
    )


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_coo_fold_identical(n_blocks):
    """A left-to-right chain of raw and coalesced COO joins equals the
    JAX package's on random signed, duplicate-heavy blocks (1-, 2- and
    3-block chains): rows, cols and weights, in order."""
    dims = [30, 25, 20, 15][: n_blocks + 1]
    out = {}
    for name, mod, summed_matmul in (("jax", jsp, jsp._matmul_summed),
                                     ("torch", tsp, tsp.matmul_summed)):
        rng = np.random.default_rng(100 + n_blocks)
        blocks = [_random_coo(mod, rng, (dims[i], dims[i + 1]), 60,
                              signed=True)
                  for i in range(n_blocks)]
        raw = summed = blocks[0]
        for b in blocks[1:]:
            raw = mod.coo_matmul(raw, b)
            summed = summed_matmul(summed, b)
        out[name] = (raw, raw.summed(), summed)
    for a, b in zip(out["jax"], out["torch"]):
        assert a.shape == b.shape
        for x, y in ((a.rows, b.rows), (a.cols, b.cols), (a.weights, b.weights)):
            np.testing.assert_array_equal(x, y)
