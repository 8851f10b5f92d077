"""Port parity of the backends' all-pairs scores, host scoring and
asymmetric metapaths against the JAX package (exactly equal, as in
test_torch_backend.py), and the ``torch`` backend's guards: counts past
the f32-exact range raise, while top-k past K1's arms is served by K3
and K4."""

import numpy as np
import pytest

from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from torch_port_util import backend_graphs, backend_set


@pytest.fixture(scope="module")
def graphs():
    return backend_graphs()


@pytest.mark.parametrize("variant", ["rowsum", "diagonal"])
@pytest.mark.parametrize("spec", ["APVPA", "APA"])
def test_all_pairs_identical(graphs, spec, variant):
    jx, jn, tt, tn = backend_set(graphs, spec)
    got = tt.all_pairs_scores(variant)
    want = jx.all_pairs_scores(variant)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tn.all_pairs_scores(variant),
                                  jn.all_pairs_scores(variant))


@pytest.mark.parametrize("variant", ["rowsum", "diagonal"])
def test_host_scoring_identical(graphs, variant):
    jx, jn, tt, tn = backend_set(graphs, "APVPA")
    for row in (0, 11, 250):
        want = jn.scores_from_source(row, variant)
        for b in (tt, tn):
            np.testing.assert_array_equal(b.scores_from_source(row, variant),
                                          want)
        jv, ji = jx.topk_row(row, k=7, variant=variant)
        tv, ti = tt.topk_row(row, k=7, variant=variant)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tt.diagonal(), jn.diagonal())


@pytest.mark.parametrize("spec", ["APV", "APVPAPT"])
def test_asymmetric_metapath_identical(graphs, spec):
    jx, jn, tt, tn = backend_set(graphs, spec)
    np.testing.assert_array_equal(tt.global_walks(), jx.global_walks())
    np.testing.assert_array_equal(tn.global_walks(), jn.global_walks())
    for row in (0, 5, 399):
        np.testing.assert_array_equal(tt.pairwise_row(row), jx.pairwise_row(row))
        np.testing.assert_array_equal(tn.pairwise_row(row), jn.pairwise_row(row))
    np.testing.assert_array_equal(tt.commuting_matrix(), jx.commuting_matrix())
    np.testing.assert_array_equal(tn.commuting_matrix(), jn.commuting_matrix())
    with pytest.raises(ValueError, match="symmetric"):
        tt.topk(k=3)


def test_topk_past_the_ported_kernels_raises(graphs, monkeypatch):
    """k > 16 and shapes past K1's candidate budget raise no
    NotImplementedError: K4 and K3 serve them, with the JAX package's
    dense top-k as the result."""
    jx, _, tt, _ = backend_set(graphs, "APVPA")
    for got, want in zip(tt.topk(k=17), jx.topk(k=17)):
        np.testing.assert_array_equal(got, np.asarray(want))
    want = jx.topk(k=10)
    # past the card's candidate budget (the gate itself is tested in
    # test_torch_kernels_scores.py::test_candidate_budget)
    monkeypatch.setattr(ck, "twopass_fits", lambda n, k, device, v=None: False)
    for got, w in zip(tt.topk(k=10), want):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_exact_count_guard(graphs):
    """A count past the f32 exact range: the row sums come exact in f64
    (C's integers summed in f64), the paths that carry counts in f32
    refuse."""
    _, _, tt, _ = backend_set(graphs, "APVPA")
    tt._half()  # build C, then blow a count past the f32 exact range
    c, _ = tt._half_cache
    c[0, 0] = 2.0**24
    tt._half_cache = (c, c @ c.sum(0))
    want = c.double() @ c.double().sum(0)
    assert float(want.max()) >= 2.0**24
    np.testing.assert_array_equal(tt.global_walks(),
                                  want.numpy()[:tt.n_sources])
    with pytest.raises(OverflowError, match="2\\^24"):
        tt._denominators("rowsum")
