"""Port parity: metapath compile, the evaluation planner and the host
COO fold of distributed_pathsim_tpu_torch against the JAX package's.
The host sparse algebra (chunked_row_topk, the delta fold) is in
test_torch_sparse.py."""

import numpy as np
import pytest

from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.ops import metapath as jmeta
from distributed_pathsim_tpu.ops import planner as jplan
from distributed_pathsim_tpu.ops import sparse as jsp
from distributed_pathsim_tpu_torch.ops import metapath as tmeta
from distributed_pathsim_tpu_torch.ops import planner as tplan
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from torch_port_util import port_hin


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn.synthetic_hin(211, 317, 13, n_topics=7, seed=5)
    return jhin, port_hin(jhin)


def _steps(mp):
    return [(s.relationship, s.reverse) for s in mp.steps]


@pytest.mark.parametrize("spec", ["APVPA", "APA", "APTPA", "APVPVPA"])
def test_fold_half_and_plan_identical(graphs, spec):
    jhin, thin = graphs
    jmp = jmeta.compile_metapath(spec, jhin.schema)
    tmp = tmeta.compile_metapath(spec, thin.schema)
    assert (jmp.name, jmp.node_types, _steps(jmp)) == (
        tmp.name, tmp.node_types, _steps(tmp)
    )
    assert jmp.is_symmetric and tmp.is_symmetric
    jp = jplan.plan_metapath(jhin, jmp)
    tp = tplan.plan_metapath(thin, tmp)
    assert jp.to_dict() == tp.to_dict()
    assert jp.order_tree() == tp.order_tree()
    jc = jplan.fold_half(jhin, jmp)
    tc = tplan.fold_half(thin, tmp)
    assert jc.shape == tc.shape
    for a, b in ((jc.rows, tc.rows), (jc.cols, tc.cols),
                 (jc.weights, tc.weights)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", ["APV", "APVPAPT", "VPAPT"])
def test_asymmetric_plan_and_fold_identical(graphs, spec):
    jhin, thin = graphs
    jmp = jmeta.compile_metapath(spec, jhin.schema)
    tmp = tmeta.compile_metapath(spec, thin.schema)
    assert not tmp.is_symmetric
    jp = jplan.plan_metapath(jhin, jmp)
    tp = tplan.plan_metapath(thin, tmp)
    assert jp.to_dict() == tp.to_dict()
    jm = jplan.fold_general(jhin, jmp).summed()
    tm = tplan.fold_general(thin, tmp).summed()
    for a, b in ((jm.rows, tm.rows), (jm.cols, tm.cols),
                 (jm.weights, tm.weights)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not symmetric"):
        tplan.fold_half(thin, tmp)


def test_compile_errors_match(graphs):
    jhin, thin = graphs
    for spec in ("APXPA", "A"):
        with pytest.raises(ValueError) as je:
            jmeta.compile_metapath(spec, jhin.schema)
        with pytest.raises(ValueError) as te:
            tmeta.compile_metapath(spec, thin.schema)
        assert str(je.value) == str(te.value)


def test_coo_matmul_identical():
    rng = np.random.default_rng(3)

    def coo(mod, m, n, nnz):
        return mod.COOMatrix(
            rows=rng.integers(0, m, nnz).astype(np.int64),
            cols=rng.integers(0, n, nnz).astype(np.int64),
            weights=rng.integers(1, 4, nnz).astype(np.float64),
            shape=(m, n),
        )

    for _ in range(3):
        state = rng.bit_generator.state
        ja, jb = coo(jsp, 40, 30, 200), coo(jsp, 30, 25, 150)
        rng.bit_generator.state = state
        ta, tb = coo(tsp, 40, 30, 200), coo(tsp, 30, 25, 150)
        j = jsp.coo_matmul(ja, jb).summed()
        t = tsp.matmul_summed(ta, tb)
        for a, b in ((j.rows, t.rows), (j.cols, t.cols),
                     (j.weights, t.weights)):
            np.testing.assert_array_equal(a, b)
