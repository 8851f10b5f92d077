"""The port's multi-metapath ensemble (``models/multipath``) against the
JAX package's ``MultiMetapathScorer``, each on a FRESH instance (the JAX
scorer's answers depend on its call history, ROADMAP C caveats): per-path
scores, denominators and the weighted combination bit for bit, the
host top-k in the same order, single-source rows; the weights'
handling; and the multi-metapath CLI mode against the JAX CLI's."""

import numpy as np
import pytest

from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu.models.multipath import MultiMetapathScorer as J
from distributed_pathsim_tpu_torch.models.multipath import (
    MultiMetapathScorer as T,
)
from distributed_pathsim_tpu_torch.models.multipath import fma_f32
from torch_port_util import port_hin, run_both_clis, write_cli_gexf


@pytest.fixture(scope="module")
def graphs():
    jhin = jsyn.synthetic_hin(300, 420, 12, n_topics=5, seed=3)
    return jhin, port_hin(jhin)


def _pair(graphs, names, variant="rowsum"):
    return (J(graphs[0], names, variant=variant),
            T(graphs[1], names, variant=variant, device="cpu"))


@pytest.mark.parametrize("names,weights,variant", [
    (["APVPA", "APA"], [0.7, 0.3], "rowsum"),
    (["APVPA", "APTPA", "APA"], [0.5, 0.3, 0.2], "rowsum"),
    (["APVPA", "APTPA"], None, "diagonal"),
])
def test_ensemble_equals_jax_on_a_fresh_scorer(graphs, names, weights,
                                               variant):
    jb, tb = _pair(graphs, names, variant)
    assert tb.names == jb.names
    np.testing.assert_array_equal(tb.global_walks(), jb.global_walks())
    jb, tb = _pair(graphs, names, variant)  # fresh: topk first
    jv, ji = jb.topk(k=10, weights=weights)
    tv, ti = tb.topk(k=10, weights=weights)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tb.scores(), np.asarray(jb.scores()))
    np.testing.assert_array_equal(tb.combined_scores(weights),
                                  jb.combined_scores(weights))
    jb, tb = _pair(graphs, names, variant)  # fresh: single sources
    for row in (0, 7, 299):
        jrv, jri = jb.topk_row(row, k=8, weights=weights)
        trv, tri = tb.topk_row(row, k=8, weights=weights)
        np.testing.assert_array_equal(tri, jri)
        np.testing.assert_array_equal(trv, jrv)


def test_weights_and_refusals(graphs):
    tb = T(graphs[1], ["APVPA", "APA"], device="cpu")
    uniform = tb.combined_scores(None)
    np.testing.assert_array_equal(uniform, tb.combined_scores([0.5, 0.5]))
    s = tb.scores()
    np.testing.assert_array_equal(tb.combined_scores([1.0, 0.0]), s[0])
    with pytest.raises(ValueError, match="need 2 weights"):
        tb.combined_scores([1.0, 2.0, 3.0])
    # the sharded ensemble ranking (--n-devices): the JAX package's, bit
    # for bit, on D virtual shards against D virtual devices
    jb = J(graphs[0], ["APVPA", "APA"])
    for n_dev in (1, 3):
        got = tb.topk_sharded(k=5, weights=[0.7, 0.3], n_devices=n_dev)
        want = jb.topk_sharded(k=5, weights=[0.7, 0.3], n_devices=n_dev)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="not symmetric"):
        T(graphs[1], ["APV"], device="cpu")
    with pytest.raises(ValueError, match="unknown PathSim variant"):
        T(graphs[1], ["APA"], variant="cosine", device="cpu")


def test_fma_f32_rounds_once():
    """The combination's multiply-add rounds once, like a hardware FMA:
    against exact rational arithmetic on random f32 operands."""
    from fractions import Fraction

    import torch

    rng = np.random.default_rng(11)
    a = rng.random(4000).astype(np.float32)
    s = rng.random(4000).astype(np.float32)
    w = float(np.float32(0.3))
    got = fma_f32(torch.as_tensor(a), torch.as_tensor(s), w).numpy()
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) + Fraction(float(s[i])) * Fraction(w)
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-1)), near,
                 np.nextafter(near, np.float32(2))]
        best = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact),
                                         int(np.float32(x).view(np.int32)) & 1))
        assert got[i] == best, i


@pytest.mark.parametrize("extra", [
    ["--metapath", "APVPA,APA", "--weights", "0.7,0.3", "--top-k", "5",
     "--all-pairs"],
    ["--metapath", "APVPA,APTPA,APA", "--source", "author_4", "--top-k", "6"],
])
def test_multipath_cli_output_identical(tmp_path, capsys, extra):
    gexf = write_cli_gexf(tmp_path / "g.gexf")
    (rc_j, out_j, _), (rc_t, out_t, _) = run_both_clis(gexf, extra, capsys)
    assert rc_j == rc_t == 0
    assert out_t == out_j
    assert "Batched metapaths:" in out_t
