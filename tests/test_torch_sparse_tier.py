"""Port parity of the streaming sparse tier: ``torch-sparse``
(distributed_pathsim_tpu_torch/backends/torch_sparse.py, on the CPU)
against the JAX package's ``jax-sparse`` with the same knobs. Values and
indices bit for bit in each of the three row-tile arms (K3's plain
version, the scanned fold, the per-tile fold), the exact-rescore mode
past 2^24 bit for bit against numpy f64 arithmetic (mass ties falling
back to full rows included), the approx mode within 1e-5, and
checkpoint resume with the compute path as identity. Mirrors
tests/test_sparse.py."""

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch.backends.base import create_backend as tcreate
from torch_port_util import f64_oracle_topk, metapaths, overflow_hins, port_hin


def _graphs():
    jhin = jsyn.synthetic_hin(700, 1000, 24, seed=9)
    return jhin, port_hin(jhin)


def _pair(graphs, **knobs):
    """(jax-sparse, torch-sparse on the CPU) with the same knobs."""
    jmp, tmp = metapaths(graphs)
    return (jcreate("jax-sparse", graphs[0], jmp, **knobs),
            tcreate("torch-sparse", graphs[1], tmp, device="cpu", **knobs))


@pytest.mark.parametrize(
    "knobs,path",
    [({"tile_rows": 256}, "scan-fold"),
     ({"tile_rows": 256, "rect_kernel": True}, "rect"),
     ({"tile_rows": 300, "dense_c_budget_bytes": 0}, "tile-fold")],
)
def test_streaming_topk_matches_jax_sparse(knobs, path):
    """Tile rows smaller than N (a partial last tile), each arm."""
    jb, tb = _pair(_graphs(), **knobs)
    assert tb._run_config(10)["compute_path"] == path
    assert jb._run_config(10, False)["compute_path"] == path
    jv, ji = jb.topk_scores(k=10)
    tv, ti = tb.topk_scores(k=10)
    assert tv.dtype == np.float64 and ti.dtype == np.int64
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(ji, ti)


def test_primitives_match_jax_sparse():
    graphs = (jsyn.synthetic_hin(300, 450, 12, seed=4),)
    graphs += (port_hin(graphs[0]),)
    jb, tb = _pair(graphs, tile_rows=128)
    np.testing.assert_array_equal(jb.global_walks(), tb.global_walks())
    np.testing.assert_array_equal(jb.diag_walks(), tb.diag_walks())
    np.testing.assert_array_equal(jb.pairwise_row(131), tb.pairwise_row(131))
    rows = [0, 5, 299]
    np.testing.assert_array_equal(jb.pairwise_rows(rows),
                                  tb.pairwise_rows(rows))
    np.testing.assert_array_equal(jb.commuting_matrix(),
                                  tb.commuting_matrix())
    np.testing.assert_array_equal(jb.all_pairs_scores(),
                                  tb.all_pairs_scores())


def test_diagonal_variant_matches_jax_sparse():
    jb, tb = _pair(_graphs(), tile_rows=256, rect_kernel=True)
    jv, ji = jb.topk_scores(k=7, variant="diagonal")
    tv, ti = tb.topk_scores(k=7, variant="diagonal")
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(ji, ti)


@pytest.mark.parametrize("rect_kernel", [None, True])
def test_exact_mode_past_2_24_bit_exact_vs_f64_oracle(rect_kernel):
    """Counts past 2^24 with exact_counts=True: the f32 pass is a
    candidate prefilter and the f64 rescore makes every score bit-exact
    against numpy f64 arithmetic — through either arm."""
    rng = np.random.default_rng(61)
    counts = np.zeros((48, 6), dtype=np.int64)
    mask = rng.random((48, 6)) < 0.6
    counts[mask] = rng.integers(1500, 4000, int(mask.sum()))
    jb, tb = _pair(overflow_hins(counts), tile_rows=16,
                   rect_kernel=rect_kernel)
    assert tb._exact_rescore and jb._exact_rescore
    want_v, want_i, want_d = f64_oracle_topk(counts, k=5)
    got_v, got_i = tb.topk_scores(k=5)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(tb.global_walks(), want_d)
    np.testing.assert_array_equal(
        tb.pairwise_row(3), counts.astype(np.float64) @ counts[3])
    jv, ji = jb.topk_scores(k=5)
    np.testing.assert_array_equal(jv, got_v)
    np.testing.assert_array_equal(ji, got_i)


def test_exact_mode_mass_ties_fall_back_to_full_rows():
    """Every author identical: every score ties, the per-row certificate
    cannot hold, and the full-row fallback gives the oracle's
    ascending-column tie order, still bit-exact."""
    counts = np.full((40, 1), 5000, dtype=np.int64)  # M[i,j] = 25e6
    _, tb = _pair(overflow_hins(counts), tile_rows=8)
    assert tb._exact_rescore
    want_v, want_i, _ = f64_oracle_topk(counts, k=3)
    got_v, got_i = tb.topk_scores(k=3)
    assert tb._last_fallback_rows == 40
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)


def test_approx_mode_waives_guard_and_stays_within_gate():
    """exact_counts=False: counts past 2^24 skip the rescore phase, and
    scores stay within 1e-5 of f64 arithmetic (and of jax-sparse's)."""
    counts = np.array([[5000, 4], [10, 0], [3, 9]], dtype=np.int64)
    jb, tb = _pair(overflow_hins(counts), exact_counts=False)
    assert not tb._exact_rescore
    vals, idxs = tb.topk_scores(k=2)
    want_v, want_i, _ = f64_oracle_topk(counts, k=2)
    np.testing.assert_allclose(vals, want_v, rtol=1e-5)
    np.testing.assert_array_equal(idxs, want_i)
    np.testing.assert_allclose(vals, jb.topk_scores(k=2)[0], rtol=1e-5)


def test_checkpoint_resume_and_compute_path_identity(tmp_path):
    """Every completed row tile is a unit: a rerun on a fresh backend
    resumes all of them and returns identical arrays; a directory
    written on one arm refuses to resume on another."""
    graphs = _graphs()
    _, tmp = metapaths(graphs)
    ck_dir = str(tmp_path / "ck")
    first = tcreate("torch-sparse", graphs[1], tmp, device="cpu",
                    tile_rows=256, rect_kernel=True)
    v1, i1 = first.topk_scores(k=6, checkpoint_dir=ck_dir)
    rerun = tcreate("torch-sparse", graphs[1], tmp, device="cpu",
                    tile_rows=256, rect_kernel=True)
    rerun._topk_row_tile = None  # a resumed tile is never computed
    v2, i2 = rerun.topk_scores(k=6, checkpoint_dir=ck_dir)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(i1, i2)
    fold = tcreate("torch-sparse", graphs[1], tmp, device="cpu",
                   tile_rows=256, rect_kernel=False)
    with pytest.raises(ValueError, match="different run"):
        fold.topk_scores(k=6, checkpoint_dir=ck_dir)
