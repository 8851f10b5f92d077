"""float64 on the port's dense backend against the JAX package under x64
(tests/conftest.py turns JAX's x64 mode on for the whole test run).

``TorchDenseBackend(dtype=torch.float64)`` on the CPU runs the kernels'
plain versions in float64, so rank-all and all-pairs equal
``JaxDenseBackend(dtype=float64)`` on its XLA path: the same values, bit
for bit, in the same (descending score, ascending column) order. On the
card the kernels stay f32-input and a float64 factor is cast at their
entry behind the 2^24 guard (tests/test_torch_cuda_batch_cli.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch.backends.base import create_backend as tcreate
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import metapaths, overflow_hins, port_hin


@pytest.fixture(scope="module")
def pair():
    jhin = jsyn.synthetic_hin(200, 400, 8, seed=1)
    graphs = (jhin, port_hin(jhin))
    jmp, tmp = metapaths(graphs)
    return (jcreate("jax", jhin, jmp, dtype=jnp.float64),
            tcreate("torch", graphs[1], tmp, dtype=torch.float64,
                    device="cpu"))


@pytest.mark.parametrize("k,variant", [(5, "rowsum"), (20, "rowsum"),
                                       (5, "diagonal")])
def test_float64_topk_equals_jax_x64(pair, k, variant):
    jb, tb = pair
    jv, ji = jb.topk(k=k, variant=variant)
    tv, ti = tb.topk(k=k, variant=variant)
    assert np.asarray(jv).dtype == tv.dtype == np.float64
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(ti, np.asarray(ji))


def test_float64_all_pairs_equals_jax_x64(pair):
    jb, tb = pair
    js = np.asarray(jb.all_pairs_scores())
    ts = tb.all_pairs_scores()
    assert js.dtype == ts.dtype == np.float64
    np.testing.assert_array_equal(ts, js)


def test_float64_rows_and_walks_equal_jax_x64(pair):
    jb, tb = pair
    np.testing.assert_array_equal(tb.global_walks(), jb.global_walks())
    for r in (0, 17, 199):
        np.testing.assert_array_equal(tb.pairwise_row(r), jb.pairwise_row(r))


def test_float64_plain_versions_keep_the_dtype():
    """Each plain version computes in float64 when handed a float64
    factor (f32 inputs are unchanged); mixed dtypes still refuse."""
    rng = np.random.default_rng(3)
    c = torch.as_tensor(rng.integers(0, 3, (37, 9)).astype(np.float64))
    d = c @ c.sum(0)
    assert ck.fused_scores(c, d).dtype == torch.float64
    assert ck.fused_topk_twopass(c, d, k=4)[0].dtype == torch.float64
    assert ck.fused_topk(c, d, k=20)[0].dtype == torch.float64
    ids = torch.arange(37, dtype=torch.int32)
    v, i = ck.fused_topk_twopass_rect(c[:10], c, d[:10], d, ids[:10], k=5)
    assert v.dtype == torch.float64
    w, j = ck.fused_topk_twopass_plain(c, d, k=5)
    assert torch.equal(v, w[:10]) and torch.equal(i, j[:10])
    # on the CPU the operands pass through untouched, guard or not
    big = d * 2.0**25
    assert ck.kernel_operands(c, big)[1] is big
    with pytest.raises(TypeError):
        ck.fused_scores(c, d.float())


def test_float64_is_exact_past_the_f32_range():
    """Counts past 2^24: the float64 backend on the CPU ranks exactly
    (the f32 guard does not apply), and so does the f32 backend's
    rank-all (f64 scores of the exact counts), while its single-source
    rows refuse with a message that names --approx."""
    counts = np.array([[3000, 2000, 0], [2500, 1, 7], [0, 4096, 4096],
                       [1, 1, 1]])
    _, thin = overflow_hins(counts)
    _, tmp = metapaths((thin, thin))
    b64 = tcreate("torch", thin, tmp, dtype=torch.float64, device="cpu")
    vals, idxs = b64.topk(k=2)
    c = counts.astype(np.float64)
    m = c @ c.T
    d = m.sum(1)
    s = 2.0 * m / (d[:, None] + d[None, :])
    np.fill_diagonal(s, -np.inf)
    want = np.argsort(-s, axis=1, kind="stable")[:, :2]
    np.testing.assert_array_equal(idxs, want)
    np.testing.assert_array_equal(vals, np.take_along_axis(s, want, 1))
    b32 = tcreate("torch", thin, tmp, device="cpu")
    v32, i32 = b32.topk(k=2)
    np.testing.assert_array_equal(i32, want)
    np.testing.assert_array_equal(v32, np.take_along_axis(s, want, 1))
    with pytest.raises(OverflowError, match="--approx"):
        b32.pairwise_row(0)
