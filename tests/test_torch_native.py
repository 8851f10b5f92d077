"""The port's native host code against its Python pipeline and the JAX
package's native modules: the C++ GEXF parse + encode
(``native/gexf_native``) and the C++ COO SpGEMM of the half-chain fold
(``native/coo_native``), built with g++ into the port's ``_build/``.
Outputs are identical — same vertices, edges, index spaces, COO rows,
columns, weights and order."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_pathsim_tpu.data import gexf as jgexf
from distributed_pathsim_tpu.native import coo_native as jcoo
from distributed_pathsim_tpu.native import gexf_native as jgexf_native
from distributed_pathsim_tpu.ops import sparse as jsp
from distributed_pathsim_tpu_torch import engine
from distributed_pathsim_tpu_torch.data.encode import encode_hin
from distributed_pathsim_tpu_torch.data.gexf import read_gexf
from distributed_pathsim_tpu_torch.data.synthetic import (
    synthetic_hin,
    write_gexf,
)
from distributed_pathsim_tpu_torch.native import build, coo_native, gexf_native
from distributed_pathsim_tpu_torch.ops import metapath, planner
from distributed_pathsim_tpu_torch.ops import sparse as sp
from torch_port_util import assert_coo_equal, assert_hin_equal, port_hin


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "g.gexf"
    hin = synthetic_hin(260, 410, 11, n_topics=5, seed=17,
                        materialize_ids=True)
    write_gexf(hin, str(path))
    return str(path)


def test_native_libraries_build_into_the_port_build_dir():
    assert gexf_native.available() and coo_native.available()
    for name in ("gexf_fast", "coo_fast"):
        path = build.shared_lib(name)
        assert path == build.lib_path(name) and path.exists()
        assert path.parent == build.BUILD_DIR
        assert build.BUILD_DIR.name == "_build"
        assert build.BUILD_DIR.parent.name == "distributed_pathsim_tpu_torch"
    assert not list(build._DIR.glob("*.so"))


def test_native_encode_equals_python_pipeline_and_jax_native(gexf):
    native = gexf_native.read_gexf_encoded(gexf)
    assert_hin_equal(native, encode_hin(read_gexf(gexf, use_native=False)))
    assert_hin_equal(native, port_hin(jgexf_native.read_gexf_encoded(gexf)))
    # the engine's loaders agree too
    for loader in ("auto", "python", "native"):
        assert_hin_equal(engine.load_dataset(
            gexf, use_native=engine.USE_NATIVE_BY_LOADER[loader]), native)


def test_native_parse_equals_python_parse(gexf):
    py = read_gexf(gexf, use_native=False)
    for graph in (read_gexf(gexf, use_native=True),
                  gexf_native.read_gexf(gexf), jgexf.read_gexf(gexf)):
        assert graph.name == py.name
        assert [(v.id, v.label, v.node_type) for v in graph.vertices] == [
            (v.id, v.label, v.node_type) for v in py.vertices]
        assert [(e.src, e.dst, e.relationship) for e in graph.edges] == [
            (e.src, e.dst, e.relationship) for e in py.edges]


def _random_coo(mod, rng, shape, nnz):
    return mod.COOMatrix(
        rows=rng.integers(0, shape[0], nnz).astype(np.int64),
        cols=rng.integers(0, shape[1], nnz).astype(np.int64),
        weights=rng.integers(1, 4, nnz).astype(np.float64),
        shape=shape,
    )


@pytest.mark.parametrize("seed,m,k,n,nnz_a,nnz_b",
                         [(0, 40, 30, 50, 200, 300), (1, 7, 300, 9, 900, 40),
                          (2, 5, 5, 5, 0, 10)])
def test_native_spgemm_equals_numpy_join_and_jax_native(seed, m, k, n,
                                                        nnz_a, nnz_b):
    rng = np.random.default_rng(seed)
    a = _random_coo(sp, rng, (m, k), nnz_a)
    b = _random_coo(sp, rng, (k, n), nnz_b)
    want = sp.coo_matmul(a, b).summed()
    got = coo_native.coo_matmul_summed(a, b)
    assert_coo_equal(got, want)
    assert got.rows.dtype == want.rows.dtype
    ja = jsp.COOMatrix(a.rows, a.cols, a.weights, a.shape)
    jb = jsp.COOMatrix(b.rows, b.cols, b.weights, b.shape)
    assert_coo_equal(got, jcoo.coo_matmul_summed(ja, jb))
    wide = sp.COOMatrix(a.rows, a.cols, a.weights, (m, k + 1))
    with pytest.raises(ValueError, match="shape mismatch"):
        coo_native.coo_matmul_summed(wide, b)


@pytest.mark.parametrize("spec", ["APVPA", "APTPA"])
def test_fold_takes_the_native_join_with_identical_output(gexf, spec,
                                                          monkeypatch):
    hin = encode_hin(read_gexf(gexf, use_native=False))
    mp = metapath.compile_metapath(spec, hin.schema)
    calls = []
    real = coo_native.coo_matmul_summed

    def counted(a, b):
        calls.append(a.shape)
        return real(a, b)

    monkeypatch.setattr(coo_native, "coo_matmul_summed", counted)
    native = planner.fold_half(hin, mp)
    assert calls
    monkeypatch.setattr(coo_native, "available", lambda: False)
    assert_coo_equal(native, planner.fold_half(hin, mp))


def test_loader_degrades_and_refuses_cleanly(gexf, monkeypatch, capsys):
    """``native`` with no toolchain is a clean ValueError; ``auto`` then
    reads through Python quietly, and a native loader that keeps failing
    transiently degrades to Python with a ``degrade`` event."""
    from distributed_pathsim_tpu_torch.resilience import policy_from_env

    monkeypatch.setattr(gexf_native, "available", lambda: False)
    with pytest.raises(ValueError, match="unavailable"):
        engine.load_dataset(gexf, use_native=True)
    want = engine.load_dataset(gexf, use_native=False)
    assert_hin_equal(engine.load_dataset(gexf, use_native=None), want)
    assert "degrade" not in capsys.readouterr().err

    def flaky(path):
        raise OSError("native reader wedged")

    monkeypatch.setattr(engine, "_load_native", flaky)
    got = engine.load_dataset(gexf, use_native=None,
                              policy=policy_from_env(base_delay=0.0))
    assert_hin_equal(got, want)
    err = capsys.readouterr().err
    assert "degrade" in err and "component=loader" in err
    with pytest.raises(ValueError, match="native GEXF loader failed"):
        engine.load_dataset(gexf, use_native=True,
                            policy=policy_from_env(base_delay=0.0))
    with pytest.raises(FileNotFoundError):
        engine.load_dataset(gexf + ".missing", use_native=False)


def test_concurrent_builds_share_one_library(tmp_path):
    """Two processes building the same library at once (two router
    workers starting on one card) both load a whole library, and only
    the digest-named file is left behind."""
    code = (
        "import json, pathlib, sys\n"
        "from distributed_pathsim_tpu_torch.native import build\n"
        f"build.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "p = build.shared_lib('coo_fast')\n"
        "from distributed_pathsim_tpu_torch.native import coo_native\n"
        "print(json.dumps([str(p), coo_native.available()]))\n"
    )
    env = dict(os.environ)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [json.loads(p.communicate(timeout=300)[0].splitlines()[-1])
            for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1]
    assert [f.name for f in tmp_path.iterdir()] == [
        build.lib_path("coo_fast").name]
