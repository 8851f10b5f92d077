"""Port parity of K3 (the row tile against every column): the plain
version behind ``cuda_kernels.fused_topk_twopass_rect`` against the JAX
package's ``pallas_kernels.fused_topk_twopass_rect`` in interpret mode,
values and indices bit for bit (integer factors: every f32 sum is exact
in any order and the one division is correctly rounded, so the
tolerance is zero). Mirrors tests/test_pallas.py's rect cases: narrow
and wide-V (the K-tiled Pallas variant) factors, a row tile not aligned
to 256, padding columns, and a row whose whole top-k shares a tile with
its self column."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from torch_port_util import kernel_case


def _random_factor(seed, n, v, density=None):
    rng = np.random.default_rng(seed)
    if density is None:
        c = rng.integers(0, 3, (n, v)).astype(np.float32)
    else:
        c = (rng.random((n, v)) < density).astype(np.float32)
    return c, np.maximum(c.sum(axis=1), 1.0).astype(np.float32)


def _assert_rect_matches_pallas(c, d, i0, t, k, n_true=None):
    ids = (i0 + np.arange(t)).astype(np.int32)
    jv, ji = pk.fused_topk_twopass_rect(
        jnp.asarray(c[i0:i0 + t]), jnp.asarray(c), jnp.asarray(d[i0:i0 + t]),
        jnp.asarray(d), jnp.asarray(ids), k=k, n_true_cols=n_true,
        interpret=True,
    )
    tc, td = torch.from_numpy(c), torch.from_numpy(d)
    tv, ti = ck.fused_topk_twopass_rect(
        tc[i0:i0 + t], tc, td[i0:i0 + t], td, torch.from_numpy(ids), k=k,
        n_true_cols=n_true,
    )
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    return tv.numpy(), ti.numpy()


@pytest.mark.parametrize("k", [1, 10, 15])
def test_rect_narrow_matches_pallas(k):
    """V = 64 (config 5's width), 3000 columns: two Pallas stripes of
    2048 with padded tail columns; a 512-row tile from the middle."""
    c, d = _random_factor(3, 3000, 64)
    _, idx = _assert_rect_matches_pallas(c, d, 1024, 512, k)
    assert not (idx == (1024 + np.arange(512))[:, None]).any()  # no self


def test_rect_odd_row_tile_matches_pallas():
    """A 389-row tile starting at row 300: neither edge on a 128 or 256
    boundary."""
    c, d = _random_factor(7, 2100, 24)
    _assert_rect_matches_pallas(c, d, 300, 389, 7)


def test_rect_wide_v_matches_pallas():
    """V = 700 > 512: the K-tiled Pallas kernel (V padded to 1024, the
    accumulator carried across grid steps) against K3's V loop."""
    c, d = _random_factor(43, 1500, 700, density=0.05)
    _assert_rect_matches_pallas(c, d, 0, 256, 5)


def test_rect_self_tile_keeps_k():
    """One dominant venue: every row's best matches sit at low column
    ids, in the tile that holds the self column. The TPU keeps k+1
    candidates per tile for this; K3 masks the self pair in the kernel.
    Both must still return k exact winners."""
    rng = np.random.default_rng(5)
    c = np.zeros((512, 8), dtype=np.float32)
    c[:, 0] = rng.integers(1, 4, 512)
    d = np.maximum(c.sum(axis=1), 1.0).astype(np.float32)
    _, idx = _assert_rect_matches_pallas(c, d, 0, 512, 5)
    assert not (idx == np.arange(512)[:, None]).any()


def test_rect_padding_columns_never_win():
    """Rows of the column factor past ``n_true_cols`` (capacity padding)
    are -inf columns and never a winner."""
    c, d = _random_factor(11, 900, 16)
    c = np.concatenate([c, np.ones((37, 16), dtype=np.float32)])
    d = np.concatenate([d, np.full(37, 16.0, dtype=np.float32)])
    _, idx = _assert_rect_matches_pallas(c, d, 128, 300, 10, n_true=900)
    assert idx.max() < 900


def test_rect_real_factor_matches_pallas():
    """The APVPA half factor of a synthetic DBLP graph with its row-sum
    denominators (the streaming tier's inputs), every row as one tile."""
    c, d = kernel_case("narrow")
    _assert_rect_matches_pallas(c, d, 0, c.shape[0], 10)


@pytest.mark.parametrize("stripe_tiles", [3, None])
def test_rect_candidates_reduce_to_the_top_k(stripe_tiles):
    """K3's own output (each row's top-k per stripe of columns), reduced
    by pass 2, is the plain top-k, whatever the stripe width (None: the
    width rect_stripe_tiles sets for the shape, here 1 tile)."""
    c, d = (torch.from_numpy(a) for a in _random_factor(13, 1000, 12))
    ids = torch.arange(200, 457, dtype=torch.int32)
    args = (c[200:457], c, d[200:457], d, ids, 9)
    cv, cc = ck.topk_rect_candidates_plain(*args, 990, stripe_tiles)
    st = stripe_tiles or ck.rect_stripe_tiles(257, 1000, 12, 9, "cpu")
    n_st = -(-8 // st)  # 1000 columns = 8 tiles of 128
    assert cv.shape == cc.shape == (257, n_st, 9)
    fv, fc = tsp.chunked_row_topk(cv.view(257, -1), cc.view(257, -1), 9)
    gv, gc = ck.fused_topk_twopass_rect_plain(*args, n_true_cols=990)
    assert torch.equal(fv, gv) and torch.equal(fc.long(), gc)
