"""The u8 limb arithmetic of K3 and K4 (the tensor-core kernels) on the
CPU: ``cuda_kernels.split_limbs`` splits a factor of integer path counts
exactly and refuses anything else, ``limb_product_plain`` (the kernels'
arithmetic in torch: limb products grouped by shift, s32 sums folded
into f64, one correctly rounded conversion) gives the exact integer
M = C Cᵀ, and that M fed into the plain selection equals the JAX
package's Pallas ``fused_topk`` and ``fused_topk_twopass_rect`` in
interpret mode bit for bit, on a factor with 2- and 3-limb rows whose
path counts between distinct rows stay below 2^24 (tolerance zero)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import kernel_case


def _recombine(limbs, v):
    planes = limbs.planes.long()
    return sum(planes[p, :, :v] << (8 * p) for p in range(planes.shape[0]))


@pytest.mark.parametrize("top,n_limbs", [(200, 1), (60000, 2),
                                         (2**24 - 1, 3)])
def test_split_limbs_recombines_exactly(top, n_limbs):
    """Entries of 1, 2 and 3 limbs, V = 37 (padded to 64 with zeros)."""
    rng = np.random.default_rng(top)
    c = rng.integers(0, top + 1, (45, 37)).astype(np.float64)
    c[3, 5] = top
    c[7] = 0  # an all-zero row still takes one limb
    limbs = ck.split_limbs(torch.tensor(c, dtype=torch.float32))
    assert limbs.planes.dtype == torch.uint8
    assert tuple(limbs.planes.shape) == (n_limbs, 45, 64)
    assert int(limbs.planes[:, :, 37:].max()) == 0
    assert torch.equal(_recombine(limbs, 37), torch.tensor(c).long())
    want = [1 + (m >= 256) + (m >= 65536) for m in c.max(1)]
    assert limbs.counts.tolist() == want
    assert limbs.rmax.tolist() == c.max(1).astype(int).tolist()
    assert limbs.sub.tolist() == [int(c.max())]  # one 64-row tile


@pytest.mark.parametrize("bad", [0.5, -1.0, float("nan"), float(2**24)])
def test_split_limbs_refuses_non_counts(bad):
    c = torch.ones((4, 3), dtype=torch.float32)
    c[2, 1] = bad
    with pytest.raises(ValueError, match=r"\[0, 2\^24\)"):
        ck.split_limbs(c)


def _exact_m(c):
    ci = torch.tensor(c, dtype=torch.int64)
    return ci @ ci.T


@pytest.mark.parametrize("case", ["m_past_2_31", "wide_v"])
def test_emulated_product_is_exact(case):
    """M past 2^31 (3-limb entries: the f64 fold of every shift), and V
    past FOLD_V (two s32 groups per shift): the emulation's f32 is the
    correctly rounded exact integer M."""
    rng = np.random.default_rng(11)
    if case == "m_past_2_31":
        c = rng.integers(2**23, 2**24, (20, 5)).astype(np.float64)
    else:
        v = ck.FOLD_V + 808
        c = rng.integers(0, 300, (12, v)).astype(np.float64)
    limbs = ck.split_limbs(torch.tensor(c, dtype=torch.float32))
    m = ck.limb_product_plain(limbs, limbs)
    exact = _exact_m(c)
    if case == "m_past_2_31":
        assert int(exact.max()) >= 2**31 and int(exact.max()) < 2**53
    else:
        assert limbs.planes.shape[2] > ck.FOLD_V
    assert m.dtype == torch.float32
    assert torch.equal(m, exact.double().float())


def test_emulated_selection_matches_pallas():
    """K4's and K3's functions from the emulated M: equal to the Pallas
    kernels in interpret mode (self pairs masked: a 3-limb row's own
    count is past 2^24)."""
    c, d = kernel_case("multilimb")
    limbs = ck.split_limbs(torch.from_numpy(c))
    assert sorted(set(limbs.counts.tolist())) == [1, 2, 3]
    m = ck.limb_product_plain(limbs, limbs)
    td = torch.from_numpy(d)
    den = td[:, None] + td[None, :]
    s = torch.where(den > 0, (2.0 * m) / den, 0.0)
    s.fill_diagonal_(float("-inf"))
    tv, ti = ck._sorted_topk(s, 20)
    jv, ji = pk.fused_topk(jnp.asarray(c), jnp.asarray(d), k=20,
                           mask_self=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())

    i0, t, n_true = 37, 129, c.shape[0] - 2
    ids = np.arange(i0, i0 + t, dtype=np.int32)
    mr = ck.limb_product_plain(limbs.rows(i0, i0 + t), limbs)
    sr = torch.where(den[i0:i0 + t] > 0, (2.0 * mr) / den[i0:i0 + t], 0.0)
    cols = torch.arange(c.shape[0])
    sr.masked_fill_((cols[None, :] >= n_true)
                    | (cols[None, :] == torch.from_numpy(ids)[:, None].long()),
                    float("-inf"))
    rv, ri = ck._sorted_topk(sr, 10)
    jv, ji = pk.fused_topk_twopass_rect(
        jnp.asarray(c[i0:i0 + t]), jnp.asarray(c), jnp.asarray(d[i0:i0 + t]),
        jnp.asarray(d), jnp.asarray(ids), k=10, n_true_cols=n_true,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(jv), rv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ri.numpy())


def _zipf_like(case):
    """A factor of 805 rows (seven 128-row blocks, the last ragged) of
    small counts, with big rows placed per ``case``: a head row in block
    0 or a middle row in block 3 (entries 2^23: their blocks' M may pass
    2^31), one in every block, or none of those but a row of large sum
    and one of large entry in different blocks (the whole factor's bound
    passes 2^31, no block's does)."""
    rng = np.random.default_rng(5)
    c = rng.integers(0, 4, (805, 64)).astype(np.float64)
    big = {"head": [0], "middle": [3 * 128 + 5],
           "every": [b * 128 + 7 for b in range(7)], "none": []}[case]
    c[big, :8] = 2**23
    if case == "none":
        c[130] = 1000  # row sum 64000, largest entry 1000
        c[600, 9] = 40000  # row sum and largest entry about 40000
    return c, sorted({r // ck.TILE for r in big})


@pytest.mark.parametrize("case", ["head", "middle", "none", "every"])
def test_row_block_wide_flags_and_launch_lists(case):
    """K1's and K4's instance per 128-row block: each block's flag is
    _needs_wide of its rows against the whole factor, and the wide and
    narrow launch lists split the launch order (most limbs first) in two,
    each keeping that order."""
    c, want_wide = _zipf_like(case)
    lim = ck.split_limbs(torch.tensor(c, dtype=torch.float32))
    n, nb = c.shape[0], -(-c.shape[0] // ck.TILE)
    flags = [ck._needs_wide(lim.rows(b * ck.TILE, min(n, (b + 1) * ck.TILE)),
                            lim) for b in range(nb)]
    assert lim.host_wide.tolist() == flags
    assert np.flatnonzero(lim.host_wide).tolist() == want_wide
    if case == "none":
        assert ck._needs_wide(lim, lim)  # cleared per block, not as a whole
    block_max = [int(c[b * ck.TILE:(b + 1) * ck.TILE].max())
                 for b in range(nb)]
    assert lim.blocks.tolist() == block_max
    n_limbs = torch.tensor([1 + (m >= 256) + (m >= 65536) for m in block_max])
    order = lim.order.tolist()
    assert order == torch.sort(-n_limbs, stable=True).indices.tolist()
    wide, narrow = lim.wide_order.tolist(), lim.narrow_order.tolist()
    assert sorted(wide + narrow) == list(range(nb))
    assert wide == [b for b in order if flags[b]]
    assert narrow == [b for b in order if not flags[b]]
    for part in (wide, narrow):
        assert n_limbs[part].tolist() == sorted(n_limbs[part].tolist(),
                                                reverse=True)
    if not want_wide:
        assert wide == []
