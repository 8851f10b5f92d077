"""Port parity of the dense backend's rank-all dispatch
(``torch_dense.TorchDenseBackend.topk`` against the JAX package's
``jax_dense.JaxDenseBackend.topk``): K1 while its candidate buffer fits,
then row tiles through K3 (the rect arm) with the self mask and f32,
otherwise the single-pass K4. Mirrors tests/test_pallas.py's routing
cases; values and indices bit for bit. The backend splits its factor
into the kernels' u8 limbs once and hands the split to every launch."""

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.backends import jax_dense
from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu_torch.backends import torch_dense
from distributed_pathsim_tpu_torch.backends.base import create_backend as tcreate
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import (
    f64_oracle_topk,
    metapaths,
    overflow_hins,
    port_hin,
)


def _graphs(n, seed):
    jhin = jsyn.synthetic_hin(n, int(n * 1.4), 24, seed=seed)
    return jhin, port_hin(jhin)


def _counting(monkeypatch, name, calls):
    real = getattr(ck, name)

    def wrapped(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(ck, name, wrapped)


def test_dense_topk_routes_rect_beyond_twopass_budget(monkeypatch):
    """Past K1's candidate budget the dense tier streams row tiles
    through K3 (the JAX package: the rect kernel), not the single-pass
    fold. Simulated by failing twopass_fits at a small N; tiles of 256
    rows exercise the multi-tile loop and the final partial tile."""
    graphs = _graphs(700, 9)
    jmp, tmp = metapaths(graphs)
    monkeypatch.setattr(pk, "twopass_fits", lambda n: False)
    monkeypatch.setattr(jax_dense.JaxDenseBackend, "_RECT_TILE_ROWS", 256)
    jv, ji = jcreate("jax", graphs[0], jmp, use_pallas=True).topk(k=5)

    monkeypatch.setattr(ck, "twopass_fits", lambda n, k, device, v=None: False)
    monkeypatch.setattr(torch_dense.TorchDenseBackend, "_RECT_TILE_ROWS", 256)
    calls = {}
    _counting(monkeypatch, "fused_topk_twopass_rect", calls)
    _counting(monkeypatch, "fused_topk", calls)
    tv, ti = tcreate("torch", graphs[1], tmp, device="cpu").topk(k=5)
    assert calls == {"fused_topk_twopass_rect": 3}  # 700 rows / 256
    np.testing.assert_array_equal(np.asarray(jv), tv)
    np.testing.assert_array_equal(np.asarray(ji), ti)


def test_dense_rect_gate_respects_mask_self(monkeypatch):
    """mask_self=False must not take the rect arm (K3 always excludes
    the self pair): it falls through to K4, and agrees with the JAX
    package's dense top-k."""
    graphs = _graphs(300, 3)
    jmp, tmp = metapaths(graphs)
    monkeypatch.setattr(ck, "twopass_fits", lambda n, k, device, v=None: False)
    calls = {}
    _counting(monkeypatch, "fused_topk_twopass_rect", calls)
    _counting(monkeypatch, "fused_topk", calls)
    tv, ti = tcreate("torch", graphs[1], tmp, device="cpu").topk(
        k=3, mask_self=False)
    assert calls == {"fused_topk": 1}
    jv, ji = jcreate("jax", graphs[0], jmp, use_pallas=False).topk(
        k=3, mask_self=False)
    np.testing.assert_array_equal(np.asarray(jv), tv)
    np.testing.assert_array_equal(np.asarray(ji), ti)


@pytest.mark.parametrize("k", [17, 40])
def test_dense_topk_above_16_routes_fold(monkeypatch, k):
    """k > 16 is K4's (the JAX package: fused_topk); the result equals
    the JAX package's dense top-k."""
    graphs = _graphs(400, 13)
    jmp, tmp = metapaths(graphs)
    calls = {}
    _counting(monkeypatch, "fused_topk_twopass", calls)
    _counting(monkeypatch, "fused_topk", calls)
    tv, ti = tcreate("torch", graphs[1], tmp, device="cpu").topk(k=k)
    assert calls == {"fused_topk": 1}
    jv, ji = jcreate("jax", graphs[0], jmp, use_pallas=False).topk(k=k)
    np.testing.assert_array_equal(np.asarray(jv), tv)
    np.testing.assert_array_equal(np.asarray(ji), ti)


def test_dense_backend_splits_once_and_hands_limbs_to_kernels(monkeypatch):
    """The backend splits C into u8 limbs once per graph
    (``cuda_kernels.kernel_limbs``; on the card, where the kernels read
    them) and hands that one split to K1 (k <= 16), K4 (k > 16), K2
    (all-pairs) and the rect arm's K3 launches (row-tile slices of it),
    so no call pays the split again. On the CPU the split is stood in
    by the real one so the hand-over shows; results stay the JAX
    package's."""
    graphs = _graphs(300, 5)
    jmp, tmp = metapaths(graphs)
    splits = []

    def kernel_limbs(c):
        splits.append(tuple(c.shape))
        return ck.split_limbs(c)

    monkeypatch.setattr(ck, "kernel_limbs", kernel_limbs)
    seen = {}
    for name in ("fused_topk_twopass", "fused_topk", "fused_scores",
                 "fused_topk_twopass_rect"):
        def wrapped(*a, _real=getattr(ck, name), _name=name, **kw):
            seen.setdefault(_name, []).append(kw.get("limbs"))
            return _real(*a, **kw)

        monkeypatch.setattr(ck, name, wrapped)
    backend = tcreate("torch", graphs[1], tmp, device="cpu")
    tv, ti = backend.topk(k=5)
    backend.topk(k=20)
    backend.all_pairs_scores()
    monkeypatch.setattr(ck, "twopass_fits", lambda n, k, device, v=None: False)
    monkeypatch.setattr(torch_dense.TorchDenseBackend, "_RECT_TILE_ROWS", 128)
    rv, ri = backend.topk(k=5)
    assert splits == [(300, 24)]  # C: 300 authors x 24 venues
    lim = seen["fused_topk_twopass"][0]
    assert isinstance(lim, ck.Limbs)
    assert seen["fused_topk"] == [lim] and seen["fused_scores"] == [lim]
    tiles = seen["fused_topk_twopass_rect"]
    assert len(tiles) == 3  # 300 rows / 128
    for i, (rows, cols) in enumerate(tiles):
        assert cols is lim
        assert torch.equal(rows.planes, lim.planes[:, 128 * i:128 * (i + 1)])
    jv, ji = jcreate("jax", graphs[0], jmp, use_pallas=False).topk(k=5)
    for vals, idxs in ((tv, ti), (rv, ri)):
        np.testing.assert_array_equal(np.asarray(jv), vals)
        np.testing.assert_array_equal(np.asarray(ji), idxs)


def test_rect_gates():
    assert ck.rect_supported(64, 10) and ck.rect_supported(4096, 15)
    assert not ck.rect_supported(64, 16) and not ck.rect_supported(64, 0)
    # stripes as wide as still gives 512 (row block, stripe) units: at
    # the config-5 tile (8192 x 1M) 8 stripes of 1024 tiles, 8 sets of k
    # candidates a row
    assert ck.rect_stripe_tiles(8192, 1 << 20, 64, 10, "cpu") == 1024
    assert ck.rect_candidate_bytes(1 << 20, 8192, 10, 64, "cpu") \
        == 8192 * 8 * 10 * 8
    # 16 stripes x 32 rows
    assert ck.rect_stripe_tiles(4096, 32768, 384, 10, "cpu") == 16
    # small: a stripe a tile
    assert ck.rect_stripe_tiles(256, 1000, 12, 10, "cpu") == 1
    # no buffer on the CPU
    assert ck.rect_fits(1 << 24, 1 << 20, 15, "cpu", 64)
    c = torch.ones((5, 3), dtype=torch.float64)
    cc, dc, limbs = ck.rect_pad_factor(c, c.sum(1))
    assert cc.dtype == dc.dtype == torch.float32 and cc.shape == (5, 3)
    assert limbs is None  # the CPU's plain version takes any f32
    ids = torch.arange(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="k<16"):
        ck.fused_topk_twopass_rect(cc, cc, dc, dc, ids, k=16)


def test_approx_waives_the_dense_guard():
    """``exact_counts=False`` (the CLI's --approx) lets the dense backend
    rank a graph whose counts pass 2^24; scores stay within 1e-5 of f64
    arithmetic. With exact counts it ranks the same graph by f64 scores
    of the exact counts, bit for bit the f64 oracle's, while the paths
    that carry counts in f32 (a single-source row) keep the guard."""
    counts = np.array([[5000, 3], [10, 0], [7, 2]])
    graphs = overflow_hins(counts)
    _, tmp = metapaths(graphs)
    thin = graphs[1]
    want_v, want_i, _ = f64_oracle_topk(counts, 2)
    exact = tcreate("torch", thin, tmp, device="cpu")
    vals, idxs = exact.topk(k=2)
    assert vals.dtype == np.float64
    np.testing.assert_array_equal(vals, want_v)
    np.testing.assert_array_equal(idxs, want_i)
    with pytest.raises(OverflowError):
        exact.pairwise_row(0)
    vals, idxs = tcreate("torch", thin, tmp, device="cpu",
                         exact_counts=False).topk(k=2)
    np.testing.assert_allclose(vals, want_v, rtol=1e-5)
    np.testing.assert_array_equal(idxs, want_i)
