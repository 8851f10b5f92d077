"""Port parity: the data layer (schema, encode, GEXF, synthetic graphs)
of distributed_pathsim_tpu_torch against the JAX package's."""

import numpy as np
import pytest

from distributed_pathsim_tpu.data import encode as jenc
from distributed_pathsim_tpu.data import gexf as jgexf
from distributed_pathsim_tpu.data import synthetic as jsyn
from distributed_pathsim_tpu_torch.data import encode as tenc
from distributed_pathsim_tpu_torch.data import gexf as tgexf
from distributed_pathsim_tpu_torch.data import synthetic as tsyn
from torch_port_util import assert_hin_equal, hin_state, port_hin


@pytest.mark.parametrize(
    "seed,topics,materialize",
    [(0, 0, False), (1, 5, True), (7, 0, True), (42, 3, False)],
)
def test_synthetic_hin_identical(seed, topics, materialize):
    args = dict(n_authors=97, n_papers=151, n_venues=9, n_topics=topics,
                seed=seed, materialize_ids=materialize)
    assert_hin_equal(jsyn.synthetic_hin(**args), tsyn.synthetic_hin(**args))


def test_write_gexf_bytes_identical(tmp_path):
    args = dict(n_authors=60, n_papers=90, n_venues=6, n_topics=4, seed=3,
                materialize_ids=True)
    jsyn.write_gexf(jsyn.synthetic_hin(**args), str(tmp_path / "j.gexf"))
    tsyn.write_gexf(tsyn.synthetic_hin(**args), str(tmp_path / "t.gexf"))
    assert (tmp_path / "j.gexf").read_bytes() == (tmp_path / "t.gexf").read_bytes()


def test_gexf_round_trip_matches(tmp_path):
    path = str(tmp_path / "g.gexf")
    jsyn.write_gexf(
        jsyn.synthetic_hin(120, 180, 8, n_topics=5, seed=11,
                           materialize_ids=True),
        path,
    )
    jg = jgexf.read_gexf(path, use_native=False)
    tg = tgexf.read_gexf(path)
    assert jg.vertex_tuples() == tg.vertex_tuples()
    assert jg.edge_tuples() == tg.edge_tuples()
    assert jg.name == tg.name
    assert_hin_equal(jenc.encode_hin(jg), tenc.encode_hin(tg))


def test_encoded_hin_from_arrays_reproduces_jax_hin(tmp_path):
    # a graph read from a file (string ids) and an implicit-range one
    path = str(tmp_path / "g.gexf")
    jsyn.write_gexf(
        jsyn.synthetic_hin(50, 70, 5, seed=2, materialize_ids=True), path
    )
    from_file = jenc.encode_hin(jgexf.read_gexf(path, use_native=False))
    implicit = jsyn.synthetic_hin(200, 300, 12, n_topics=6, seed=9)
    for jhin in (from_file, implicit):
        assert_hin_equal(jhin, port_hin(jhin))
        assert_hin_equal(jhin, tenc.encoded_hin_from_arrays(hin_state(jhin)))


def test_encoded_hin_from_arrays_copies_and_validates():
    jhin = jsyn.synthetic_hin(30, 40, 4, seed=1, materialize_ids=True)
    state = hin_state(jhin)
    hin = tenc.encoded_hin_from_arrays(state)
    before = hin.block("author_of").rows.copy()
    state["blocks"]["author_of"]["rows"][0] += 1  # the caller's array
    np.testing.assert_array_equal(hin.block("author_of").rows, before)
    state["types"]["author"]["labels"] = state["types"]["author"]["labels"][:-1]
    with pytest.raises(ValueError, match="labels"):
        tenc.encoded_hin_from_arrays(state)


def test_factor_from_arrays_hands_float32_tensors():
    import torch

    c = np.arange(12, dtype=np.float64).reshape(4, 3)
    d = c @ c.sum(0)
    tc, td = tenc.factor_from_arrays(c, d, "cpu")
    assert tc.dtype == td.dtype == torch.float32
    assert tc.is_contiguous() and tuple(tc.shape) == (4, 3)
    np.testing.assert_array_equal(td.numpy(), d.astype(np.float32))
    with pytest.raises(ValueError):
        tenc.factor_from_arrays(c, d[:3], "cpu")
