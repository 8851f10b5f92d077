"""Port parity: the port's ``torch`` backend (on the CPU, where the
kernels' plain versions run) and ``numpy`` oracle against the JAX
package's ``jax`` backend (its CPU/XLA path) and ``numpy`` backend —
exactly equal counts, scores, top-k values, indices and tie order. The
all-pairs, host-scoring, asymmetric and guard cases are in
test_torch_backend_scoring.py."""

import numpy as np
import pytest

from distributed_pathsim_tpu_torch.backends.base import available_backends
from torch_port_util import backend_graphs, backend_set


@pytest.fixture(scope="module")
def graphs():
    return backend_graphs()


def test_registry():
    assert available_backends() == ["numpy", "torch", "torch-sharded",
                                    "torch-sparse"]


@pytest.mark.parametrize("spec", ["APVPA", "APA", "APTPA"])
def test_counts_and_rows_identical(graphs, spec):
    jx, jn, tt, tn = backend_set(graphs, spec)
    gw = jx.global_walks()
    for b in (jn, tt, tn):
        np.testing.assert_array_equal(b.global_walks(), gw)
    for row in (0, 1, 57, 399):
        want = jx.pairwise_row(row)
        for b in (jn, tt, tn):
            np.testing.assert_array_equal(b.pairwise_row(row), want)
    rows = np.array([3, 0, 399, 3])
    np.testing.assert_array_equal(tt.pairwise_rows(rows), jx.pairwise_rows(rows))
    np.testing.assert_array_equal(tt.commuting_matrix(), jx.commuting_matrix())
    np.testing.assert_array_equal(tn.commuting_matrix(), jn.commuting_matrix())


@pytest.mark.parametrize("spec", ["APVPA", "APA"])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_topk_identical(graphs, spec, k):
    jx, _, tt, _ = backend_set(graphs, spec)
    jv, ji = jx.topk(k=k)
    tv, ti = tt.topk(k=k)
    assert tv.dtype == np.float32
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    jv, ji = jx.topk(k=k, variant="diagonal")
    tv, ti = tt.topk(k=k, variant="diagonal")
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(ti, np.asarray(ji))
