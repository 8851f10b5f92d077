"""Port parity: the ANN tier's candidate index (index/, models/neural.py)
against the JAX package on the CPU.

- the quadrature grid, its gates and the analytic struct embeddings are
  equal array for array, with and without the JL projection;
- ``CentroidIndex.build`` gives equal centroids, members, packed blocks
  and slots for the same embeddings, K, cap and seed (the raised-cap
  case included), and the ``.npz`` artifact loads across the packages
  with the fingerprint guard intact;
- the host route gives equal arrays and the port's device route (torch
  ops, here on a CPU device) equals the JAX jitted route id for id,
  also when every centroid ties; the shortlist probe's similarities
  agree within 1e-6 relative with equal member ids, pads and self at
  −inf;
- a stale / refresh sequence leaves equal arrays and unplaced lists;
- ``dpathsim-torch index build/probe --platform cpu`` prints the JSON
  of ``dpathsim index build/probe`` (timings aside), and the learned
  embedding is refused by name.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.index import CentroidIndex as JIndex
from distributed_pathsim_tpu.index import build_index as jbuild
from distributed_pathsim_tpu.index import build as jbuild_mod
from distributed_pathsim_tpu.models import neural as jneural
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu_torch.index import (
    CentroidIndex,
    IndexMismatch,
    build_index,
)
from distributed_pathsim_tpu_torch.index import build as tbuild_mod
from distributed_pathsim_tpu_torch.models import neural as tneural
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from torch_port_util import port_hin

ARRAYS = ("centroids", "members", "packed", "cluster_of", "slot_of", "stale")


@pytest.fixture(scope="module")
def small():
    """(JAX C, d), (port C, d) of APVPA on synthetic_hin(300, 520, 12)."""
    jhin = jsyn(300, 520, 12, seed=7)
    thin = port_hin(jhin)
    jc, jd = jbuild_mod.half_chain_and_denominators(
        jhin, jcompile("APVPA", jhin.schema))
    tc, td = tbuild_mod.half_chain_and_denominators(
        thin, compile_metapath("APVPA", thin.schema))
    assert np.array_equal(jc, tc) and np.array_equal(jd, td)
    return jc, jd


def _assert_index_equal(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert tuple(a.token) == tuple(b.token)
    assert a.meta == b.meta


def test_quadrature_and_struct_embeddings_equal_jax(small):
    c, d = small
    assert tneural.QUAD_M == jneural.NeuralPathSim.QUAD_M == 12
    jt, jw = jneural.cauchy_quadrature(d, m=12)
    tt, tw = tneural.cauchy_quadrature(d, m=12)
    assert np.array_equal(jt, tt) and np.array_equal(jw, tw)
    assert np.array_equal(jneural.quadrature_gates(d, jt),
                          tneural.quadrature_gates(d, tt))
    # 12 · 12 = 144 dims: unprojected at the default width, JL past 64
    for max_dim in (1024, 64):
        j = jbuild_mod.struct_embeddings(c, d, max_dim=max_dim, seed=3)
        t = tbuild_mod.struct_embeddings(c, d, max_dim=max_dim, seed=3)
        assert j.dtype == t.dtype == np.float32
        assert j.shape == t.shape and np.array_equal(j, t), max_dim
    # a degenerate graph (every denominator zero) gets the zero grid
    z = np.zeros(5)
    assert all(np.array_equal(a, b) for a, b in zip(
        jneural.cauchy_quadrature(z), tneural.cauchy_quadrature(z)))


@pytest.mark.parametrize("centroids, cap", [(9, None), (4, 8)])
def test_build_equals_jax_array_for_array(small, centroids, cap):
    """Same embeddings, K, cap and seed → the same packed index; an
    infeasible cap (4 · 8 < 300) is raised to the floor on both sides."""
    c, d = small
    kw = dict(c=c, d=d, n_centroids=centroids, cluster_cap=cap,
              token=("fp-a", 2), seed=5)
    j = jbuild(**kw)
    t = build_index(**kw, device="cpu")
    _assert_index_equal(j, t)
    if cap is not None:
        assert t.meta["cap_raised_from"] == cap
        assert t.cluster_cap * t.n_centroids >= t.n
    emb = tbuild_mod.struct_embeddings(c, d)
    _assert_index_equal(JIndex.build(emb, 7, seed=1),
                        CentroidIndex.build(emb, 7, seed=1, device="cpu"))


def test_artifact_loads_across_packages_with_the_fingerprint_guard(
        small, tmp_path):
    c, d = small
    t = build_index(c=c, d=d, n_centroids=9, token=("fp-a", 0),
                    device="cpu")
    t.mark_stale([3, 4])
    t.save(str(tmp_path / "t.npz"))
    _assert_index_equal(JIndex.load(str(tmp_path / "t.npz"),
                                    expect_base_fp="fp-a"), t)
    j = jbuild(c=c, d=d, n_centroids=9, token=("fp-b", 4))
    j.save(str(tmp_path / "j.npz"))
    back = CentroidIndex.load(str(tmp_path / "j.npz"),
                              expect_base_fp="fp-b", device="cpu")
    _assert_index_equal(back, j)
    assert back.token == ("fp-b", 4) and back.meta["embedding"] == "struct"
    with pytest.raises(IndexMismatch, match="dpathsim-torch index build"):
        CentroidIndex.load(str(tmp_path / "j.npz"), expect_base_fp="other")
    # a schema it does not know is refused by name, too
    with np.load(str(tmp_path / "j.npz")) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(payload["meta"].tobytes().decode())
    payload["meta"] = np.frombuffer(
        json.dumps({**meta, "schema_version": 99}).encode(), dtype=np.uint8)
    np.savez_compressed(str(tmp_path / "v99.npz"), **payload)
    with pytest.raises(IndexMismatch, match="schema 99"):
        CentroidIndex.load(str(tmp_path / "v99.npz"))


def _pair(centroids, packed, members, cluster_of, slot_of):
    kw = dict(centroids=centroids, members=members, packed=packed,
              cluster_of=cluster_of, slot_of=slot_of, token=("fp", 0),
              meta={})
    return JIndex(**kw), CentroidIndex(**{k: v.copy() if hasattr(v, "copy")
                                          else v for k, v in kw.items()},
                                       device="cpu")


def test_routes_equal_jax_including_tied_centroids(small):
    """The host route (numpy, a set) is the JAX one array for array; the
    device route — torch ops, a stable descending sort — equals the JAX
    jitted route id for id. With every centroid equal, every similarity
    ties: ``lax.top_k`` keeps the lowest ids, and so must the port
    (``torch.topk`` promises no tie order)."""
    c, d = small
    j = jbuild(c=c, d=d, n_centroids=12)
    t = build_index(c=c, d=d, n_centroids=12, device="cpu")
    rows = np.arange(0, 300, 7)
    for nprobe in (1, 4, 12, 40):
        jh, th = j.route_batch_host(rows, nprobe), t.route_batch_host(
            rows, nprobe)
        assert all(np.array_equal(a, b) for a, b in zip(jh, th))
        jm, jc_ = j.route_batch(rows, nprobe)
        tm, tc_ = t.route_batch(rows, nprobe)
        assert tm.dtype == np.int32 and tc_.dtype == np.int32
        assert np.array_equal(jm, tm) and np.array_equal(jc_, tc_), nprobe
        # the device route's SET equals the host route's
        assert all(set(a) == set(b) for a, b in zip(tc_, th[1]))
    # every centroid tied: K = 12 identical centroids over random blocks
    rng = np.random.default_rng(0)
    k, cap, dim, n = 12, 8, 16, 80
    packed = np.zeros((k, cap, dim), np.float32)
    members = np.full((k, cap), -1, np.int32)
    cluster_of = (np.arange(n) % k).astype(np.int32)
    slot_of = (np.arange(n) // k).astype(np.int32)
    members[cluster_of, slot_of] = np.arange(n)
    packed[cluster_of, slot_of] = rng.standard_normal((n, dim))
    cent = np.tile(rng.standard_normal(dim).astype(np.float32), (k, 1))
    jt, tt = _pair(cent, packed, members, cluster_of, slot_of)
    for nprobe in (1, 5, 11):
        jm, jc_ = jt.route_batch(np.arange(n), nprobe)
        tm, tc_ = tt.route_batch(np.arange(n), nprobe)
        assert np.array_equal(jc_, tc_) and np.array_equal(jm, tm)
        assert (tc_ == np.arange(nprobe)).all()  # lowest ids first


def test_shortlist_probe_within_1e6_with_equal_members(small):
    c, d = small
    j = jbuild(c=c, d=d, n_centroids=12)
    t = build_index(c=c, d=d, n_centroids=12, device="cpu")
    rows = np.arange(0, 300, 5)
    js, jm = j.probe_batch(rows, 5)
    ts, tm = t.probe_batch(rows, 5)
    assert ts.dtype == np.float32 and tm.dtype == np.int32
    assert np.array_equal(jm, tm)
    masked = (tm < 0) | (tm == rows[:, None])
    assert masked.any() and (tm < 0).any()
    assert np.isneginf(ts[masked]).all() and np.isneginf(js[masked]).all()
    assert np.isfinite(ts[~masked]).all()
    np.testing.assert_allclose(ts[~masked], js[~masked], rtol=1e-6,
                               atol=1e-6 * np.abs(js[~masked]).max())
    # the host selection over them agrees with the JAX index's
    for b in range(rows.shape[0]):
        assert set(t.select_candidates(ts[b], tm[b], 40)) == set(
            j.select_candidates(js[b], jm[b], 40))
    # the device mirror is a copy: a host write never reaches it
    dev = t._device_arrays()
    t.packed[0] += 1.0
    assert not torch.equal(dev[2][0], torch.from_numpy(t.packed[0]))


def test_stale_and_refresh_sequence_equals_jax(small):
    """mark_stale / refresh_rows on both packages' index: equal arrays,
    equal unplaced lists, the device mirror dropped; rows re-embedded
    with other rows' vectors move to their new nearest centroid where it
    has room."""
    c, d = small
    j = jbuild(c=c, d=d, n_centroids=9)
    t = build_index(c=c, d=d, n_centroids=9, device="cpu")
    t._device_arrays()
    rows = np.asarray([5, 17, 100, 299])
    assert t.mark_stale(np.r_[rows, 300, -1]) == j.mark_stale(
        np.r_[rows, 300, -1]) == 4
    assert not t.covers(5) and t.stale_count == 4
    quad = (np.asarray(t.meta["quad_t"]), np.asarray(t.meta["quad_w"]))
    emb = tbuild_mod.struct_embeddings(c, d, quad=quad)
    fresh = emb[rows[::-1]]  # other rows' vectors: some must move
    moved_before = t.cluster_of[rows].copy()
    assert j.refresh_rows(np.r_[rows, 400], np.r_[fresh, fresh[:1]],
                          token=("fp", 3)) == t.refresh_rows(
        np.r_[rows, 400], np.r_[fresh, fresh[:1]], token=("fp", 3)) == [400]
    assert (t.cluster_of[rows] != moved_before).any()
    _assert_index_equal(j, t)
    assert t._dev is None and t.stale_count == 0 and t.token == ("fp", 3)
    # refresh_embeddings uses the pinned grid: equal to the JAX one
    assert np.array_equal(
        tbuild_mod.refresh_embeddings(t, rows, c, d),
        jbuild_mod.refresh_embeddings(j, rows, c, d))


def _json_out(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, json.loads(buf.getvalue())


def test_index_cli_prints_the_jax_json(tmp_path):
    from distributed_pathsim_tpu.index.cli import index_main as jmain
    from distributed_pathsim_tpu_torch.cli import main as tmain

    spec = "synthetic:authors=200,papers=340,venues=8,seed=3"
    outs = {}
    for side, fn, pre in (("j", jmain, []), ("t", tmain, ["index"])):
        path = str(tmp_path / f"{side}.npz")
        rc, out = _json_out(fn, [*pre, "build", "--dataset", spec, "--out",
                                 path, *(["--platform", "cpu"] if pre
                                         else [])])
        assert rc == 0 and out.pop("out") == path
        out.pop("build_s")
        outs[side] = out
    assert outs["t"] == outs["j"]
    _assert_index_equal(JIndex.load(str(tmp_path / "j.npz")),
                        CentroidIndex.load(str(tmp_path / "t.npz")))
    for row in (0, 5, 77, 199):
        for art in ("j", "t"):
            argv = ["probe", "--index", str(tmp_path / f"{art}.npz"),
                    "--row", str(row), "--k", "5", "--dataset", spec]
            rj, pj = _json_out(jmain, argv)
            rt, pt = _json_out(tmain, ["index", *argv, "--platform", "cpu"])
            assert rj == rt == 0 and pt == pj, (row, art)
            assert pt["topk"] and pt["n_candidates"] > 0


def test_learned_embedding_and_missing_card_refused(small, tmp_path,
                                                    monkeypatch, capsys):
    from distributed_pathsim_tpu_torch.cli import main as tmain

    from distributed_pathsim_tpu_torch.data.delta import with_headroom
    from distributed_pathsim_tpu_torch.index.cli import _parse_dataset
    from distributed_pathsim_tpu_torch.models.neural import NeuralPathSim

    c, d = small
    spec = "synthetic:authors=40,papers=60,venues=4,seed=1"
    # --embedding learned is ported: a NeuralPathSim checkpoint of the
    # served graph (index build's default headroom) embeds the corpus...
    model = NeuralPathSim(with_headroom(_parse_dataset(spec), 0.25),
                          "APVPA", dim=8, hidden=16, device="cpu")
    model.train(steps=2, batch_size=64)
    model.save(str(tmp_path / "m.npz"))
    capsys.readouterr()
    assert tmain(["index", "build", "--dataset", spec, "--out",
                  str(tmp_path / "x.npz"), "--platform", "cpu",
                  "--embedding", "learned", "--model",
                  str(tmp_path / "m.npz")]) == 0
    built = json.loads(capsys.readouterr().out)
    assert (built["embedding"], built["dim"], built["n"]) == (
        "learned", 8, model.n)
    # ...and one of another graph, or none, is refused by name
    with pytest.raises(ValueError, match="retrain/rebuild"):
        build_index(c=c, d=d, embedding="learned",
                    model_path=str(tmp_path / "m.npz"), device="cpu")
    assert tmain(["index", "build", "--dataset", spec, "--out",
                  str(tmp_path / "x.npz"), "--platform", "cpu",
                  "--embedding", "learned", "--model", "m.npz"]) == 1
    assert capsys.readouterr().err.startswith("error:")  # missing file
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for action in (["build", "--dataset", spec, "--out",
                    str(tmp_path / "y.npz")],
                   ["probe", "--index", "idx.npz", "--row", "0"]):
        assert tmain(["index", *action]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    # an index without a device argument probes on the card: refused
    t = build_index(c=c, d=d, n_centroids=4)
    assert t.route_batch_host(np.arange(3), 2)[0].shape[0] == 3
    with pytest.raises(Exception, match="no CUDA device"):
        t.route_batch(np.arange(3), 2)
