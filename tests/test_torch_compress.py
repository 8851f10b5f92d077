"""Port parity: the compressed factor layouts (``ops/packed.py``) and the
hub-first permutations (``data/compress.py``) against the JAX package's,
zero tolerance. The same seeded COO factors go through both packages:
the chunk layout is the JAX package's byte for byte (every chunk array,
its dtype and its capacity bucket), so ``content_digest`` and
``factor_bytes`` are equal; pack → unpack is the identity onto canonical
COO; row slices, dense gathers and marginals equal the JAX accessors';
``patch_factor`` through a delta sequence with node appends stays equal
to the JAX package's patched factor and to the plan's patched COO; dtypes
are chosen from the actual value range (f64 fallback lossless, overflow
promoted and counted); an unknown format is refused. Twins
tests/test_compress.py (not its partition or bench tests)."""

import numpy as np
import pytest

from distributed_pathsim_tpu.data import compress as jcomp
from distributed_pathsim_tpu.data import delta as jdl
from distributed_pathsim_tpu.ops import packed as jpk
from distributed_pathsim_tpu.ops import sparse as jsp
from distributed_pathsim_tpu_torch.data import compress as tcomp
from distributed_pathsim_tpu_torch.data import delta as tdl
from distributed_pathsim_tpu_torch.ops import packed as tpk
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from torch_port_util import (
    assert_coo_equal,
    delta_graphs,
    make_delta,
    metapaths,
    random_delta_spec,
)

FORMATS = ["blocked", "bitpacked"]


def _random_coo(rng, n=None, v=None, nnz=None, wmax=300):
    """(JAX COO, port COO) of one random unsummed integer factor."""
    n = n or int(rng.integers(1, 700))
    v = v or int(rng.integers(1, 250))
    nnz = int(rng.integers(0, 3000)) if nnz is None else nnz
    arrays = dict(
        rows=rng.integers(0, n, nnz).astype(np.int64),
        cols=rng.integers(0, v, nnz).astype(np.int64),
        weights=rng.integers(1, wmax, nnz).astype(np.float64),
        shape=(n, v),
    )
    return jsp.COOMatrix(**arrays), tsp.COOMatrix(**arrays)


def _assert_layout_equal(jf, tf):
    """Every chunk array of the two packed factors: dtype, capacity and
    bytes; the permutation and the column totals."""
    assert (jf.fmt, tuple(jf.shape), jf.nnz, jf.chunk_rows, jf.perm_bytes,
            jf.promotions) == (tf.fmt, tuple(tf.shape), tf.nnz,
                               tf.chunk_rows, tf.perm_bytes, tf.promotions)
    assert len(jf.chunks) == len(tf.chunks)
    for jc, tc in zip(jf.chunks, tf.chunks):
        assert (jc.row0, jc.n_rows, jc.nnz) == (tc.row0, tc.n_rows, tc.nnz)
        for name in ("row_counts", "weights", "cols", "bits", "block_bits"):
            a, b = getattr(jc, name), getattr(tc, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("perm", "inv"):
        a, b = getattr(jf.col_perm, name), getattr(tf.col_perm, name)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jf.colsum.tobytes() == tf.colsum.tobytes()
    assert jpk.factor_bytes(jf) == tpk.factor_bytes(tf)
    assert jpk.content_digest(jf) == tpk.content_digest(tf)


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_roundtrip_and_layout_equal_jax(fmt):
    rng = np.random.default_rng(5)
    for trial in range(5):
        jc, tc = _random_coo(rng)
        canon = tsp.coo_nonzero(tc.summed())
        for chunk_rows in (1, 64, 4096):
            jf = jpk.make_factor(jc, fmt, chunk_rows=chunk_rows)
            tf = tpk.make_factor(tc, fmt, chunk_rows=chunk_rows)
            _assert_layout_equal(jf, tf)
            assert_coo_equal(tpk.as_coo(tf), canon)
            assert_coo_equal(tpk.as_coo(tf), jpk.as_coo(jf))
            # the digest is format-independent
            assert tpk.content_digest(tf) == tpk.content_digest(tc)
            assert tpk.factor_nnz(tf) == canon.rows.shape[0]
            assert tpk.is_packed(tf) and tpk.is_canonical(tf)
            assert tpk.is_canonical(canon)


@pytest.mark.parametrize("fmt", FORMATS)
def test_row_slice_gather_and_marginals_equal_jax(fmt):
    rng = np.random.default_rng(9)
    for _ in range(4):
        jc, tc = _random_coo(rng)
        n, v = tc.shape
        chunk_rows = int(rng.integers(1, 300))
        jf = jpk.make_factor(jc, fmt, chunk_rows=chunk_rows)
        tf = tpk.make_factor(tc, fmt, chunk_rows=chunk_rows)
        r0, r1 = sorted(rng.integers(0, n + 1, 2).tolist())
        assert_coo_equal(tpk.row_slice(tf, r0, r1), jpk.row_slice(jf, r0, r1))
        assert tpk.row_range_nnz(tf, r0, r1) == jpk.row_range_nnz(jf, r0, r1)
        sel = rng.integers(0, n, 9)
        np.testing.assert_array_equal(tpk.gather_rows_dense(tf, sel),
                                      jpk.gather_rows_dense(jf, sel))
        colvec = rng.integers(0, 7, v).astype(np.float64)
        np.testing.assert_array_equal(
            tpk.factor_rowsums_weighted(tf, colvec),
            jpk.factor_rowsums_weighted(jf, colvec))
        np.testing.assert_array_equal(tpk.factor_diag(tf),
                                      jpk.factor_diag(jf))
        np.testing.assert_array_equal(tpk.factor_colsum(tf),
                                      jpk.factor_colsum(jf))
        # the COO arms of the accessors too
        np.testing.assert_array_equal(tpk.factor_diag(tc),
                                      jpk.factor_diag(jc))
        assert tpk.factor_bytes(tc) == jpk.factor_bytes(jc)
        assert_coo_equal(tpk.packed_matmul(tf, tpk.make_factor(
            tsp.COOMatrix(rows=tc.cols, cols=tc.rows, weights=tc.weights,
                          shape=(v, n)), fmt)),
            jpk.packed_matmul(jf, jpk.make_factor(jsp.COOMatrix(
                rows=jc.cols, cols=jc.rows, weights=jc.weights,
                shape=(v, n)), fmt)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_patch_factor_delta_sequence_equal_jax(fmt):
    """Four product-rule deltas (two with an appended author) patched
    into the packed factor of each package: layouts and digests equal
    after every step, the content equal to the plan's patched COO."""
    rng = np.random.default_rng(11)
    jhin, thin = delta_graphs(headroom=0.3)
    jmp, tmp = metapaths((jhin, thin))
    from distributed_pathsim_tpu.ops import planner as jplan
    from distributed_pathsim_tpu_torch.ops import planner as tplan

    jf = jpk.make_factor(jplan.fold_half(jhin, jmp), fmt, chunk_rows=32)
    tf = tpk.make_factor(tplan.fold_half(thin, tmp), fmt, chunk_rows=32)
    _assert_layout_equal(jf, tf)
    for step in range(4):
        spec = random_delta_spec(thin, rng, append=step % 2 == 0)
        jplan_d = jdl.plan_delta(jhin, make_delta(jdl, spec), jmp,
                                 max_delta_fraction=0.5)
        tplan_d = tdl.plan_delta(thin, make_delta(tdl, spec), tmp,
                                 max_delta_fraction=0.5)
        assert not tplan_d.fallback, tplan_d.reason
        jf = jpk.patch_factor(jf, jplan_d.delta_c)
        tf = tpk.patch_factor(tf, tplan_d.delta_c)
        _assert_layout_equal(jf, tf)
        assert_coo_equal(tpk.as_coo(tf),
                         tsp.coo_nonzero(tplan_d.half_new.summed()))
        jhin, thin = jplan_d.hin_new, tplan_d.hin_new


def test_narrow_dtypes_f64_fallback_and_loud_promotion():
    from distributed_pathsim_tpu_torch.obs.metrics import get_registry

    rows, cols = np.zeros(2, dtype=np.int64), np.arange(2, dtype=np.int64)
    for w, dt in (([3.0, 200.0], np.uint8), ([3.0, 70000.0], np.uint32)):
        arrays = dict(rows=rows, cols=cols, weights=np.array(w), shape=(2, 4))
        tf = tpk.make_factor(tsp.COOMatrix(**arrays), "blocked")
        assert tf.chunks[0].weights.dtype == dt
        assert tpk.as_coo(tf).weights.tolist() == w
        _assert_layout_equal(
            jpk.make_factor(jsp.COOMatrix(**arrays), "blocked"), tf)
    # non-integer weights: lossless f64, counted
    reg = get_registry()
    for fmt in FORMATS:
        cell = reg.counter("dpathsim_packed_f64_fallback_total").labels(
            format=fmt)
        before = cell.value
        c = tsp.COOMatrix(rows=rows, cols=cols,
                          weights=np.array([0.5, -2.25]), shape=(2, 4))
        out = tpk.as_coo(tpk.make_factor(c, fmt))
        assert sorted(out.weights.tolist()) == [-2.25, 0.5]
        assert cell.value == before + 1
    # a patch past the narrow dtype promotes (counted), never wraps
    for fmt in FORMATS:
        cell = reg.counter("dpathsim_packed_promotions_total").labels(
            format=fmt)
        before = cell.value
        c = tsp.COOMatrix(rows=np.zeros(3, dtype=np.int64),
                          cols=np.arange(3, dtype=np.int64),
                          weights=np.ones(3), shape=(4, 4))
        f = tpk.make_factor(c, fmt, chunk_rows=4)
        dc = tsp.COOMatrix(rows=np.zeros(1, dtype=np.int64),
                           cols=np.zeros(1, dtype=np.int64),
                           weights=np.array([300.0]), shape=(4, 4))
        f2 = tpk.patch_factor(f, dc)
        assert tpk.as_coo(f2).weights[0] == 301.0  # exact: 301, not 45
        assert f2.promotions == f.promotions + 1
        assert cell.value == before + 1


def test_unknown_format_refused_and_coo_passthrough():
    jc, tc = _random_coo(np.random.default_rng(1))
    assert tpk.make_factor(tc, "coo") is tc
    assert tpk.as_coo(tc) is tc
    assert tpk.FACTOR_FORMATS == jpk.FACTOR_FORMATS
    with pytest.raises(ValueError, match="unknown factor format"):
        tpk.make_factor(tc, "zstd")
    with pytest.raises(TypeError, match="COO factor"):
        tpk.make_factor(tpk.make_factor(tc, "blocked"), "bitpacked")
    with pytest.raises(TypeError, match="packed factors only"):
        tpk.patch_factor(tc, tc)


def test_permutation_helpers_equal_jax():
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 5, 200)
    np.testing.assert_array_equal(tcomp.degree_order(deg),
                                  jcomp.degree_order(deg))
    order = tcomp.degree_order(deg)
    assert (np.diff(deg[order]) <= 0).all()  # hub-first
    pair = tcomp.PermutationPair.from_perm(order)
    idx = rng.integers(0, 200, 50)
    np.testing.assert_array_equal(pair.invert(pair.apply(idx)), idx)
    ext = pair.extend(230)
    np.testing.assert_array_equal(ext.apply(np.arange(200, 230)),
                                  np.arange(200, 230))
    with pytest.raises(ValueError, match="shrink"):
        pair.extend(10)
    assert tcomp.PermutationPair.identity(7).is_identity
    jhin, thin = delta_graphs(headroom=0.3)
    jp, tp = (jcomp.hin_degree_permutations(jhin),
              tcomp.hin_degree_permutations(thin))
    assert sorted(jp) == sorted(tp)
    for t in tp:
        np.testing.assert_array_equal(tp[t].perm, jp[t].perm)
        np.testing.assert_array_equal(tp[t].inv, jp[t].inv)
    _, tc = _random_coo(rng, n=300, v=40, nnz=900)
    for a, b in zip(tcomp.factor_permutations(tc.rows, tc.cols, tc.shape),
                    jcomp.factor_permutations(tc.rows, tc.cols, tc.shape)):
        np.testing.assert_array_equal(a.perm, b.perm)
