"""Port parity: the learned tier's training (learned/trainer.py, the
service's in-process distillation, ``dpathsim-torch learned train`` and
the training flags) against the JAX package's, on tests/test_learned.py's
fixture graph.

- ``_pairs_to_pool`` and the hard pool ``train_towers`` installs (mined
  lists + ``--emit-pairs`` rows) equal the JAX package's bit for bit;
- a learned-mode service with no checkpoint distills its own towers
  (``learned_steps=40``, ``learned_cand_mult=32``: every row a
  candidate) and every learned answer is bit-identical to the exact
  lane's and to the JAX service's — eligible rows, the cold-start
  append before and after ``refresh_towers``, a service booted from the
  distilled checkpoint, a foreign checkpoint replaced by retraining, and
  a later install (a reload onto another graph) that rejects the towers
  and retrains, as the JAX service does;
- ``learned train`` + ``inspect`` against the JAX CLI's JSON, and the
  training flags through ``serve`` / ``worker`` / ``router``.

The two packages draw different initial weights, so distilled towers
differ; the answers do not, because the exact rerank decides them.
"""

import json

import numpy as np
import pytest

from distributed_pathsim_tpu.backends.base import create_backend as jcreate
from distributed_pathsim_tpu.data import delta as jdelta
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.learned import trainer as jtrainer
from distributed_pathsim_tpu.models.neural import NeuralPathSim as JNeural
from distributed_pathsim_tpu.ops.metapath import compile_metapath as jcompile
from distributed_pathsim_tpu.serving import PathSimService as JService
from distributed_pathsim_tpu.serving import ServeConfig as JConfig
from distributed_pathsim_tpu.tuning import dispatch as jtuning
from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.backends.base import create_backend
from distributed_pathsim_tpu_torch.data import delta as tdelta
from distributed_pathsim_tpu_torch.learned import save_towers, trainer
from distributed_pathsim_tpu_torch.models.neural import NeuralPathSim
from distributed_pathsim_tpu_torch.ops.metapath import compile_metapath
from distributed_pathsim_tpu_torch.serving import PathSimService, ServeConfig
from torch_port_util import port_hin

DISTILL = dict(max_wait_ms=0.5, warm=False, compact_auto=False,
               topk_mode="learned", learned_steps=40,
               learned_shadow_every=0, learned_auto_refresh=False,
               learned_cand_mult=32)


@pytest.fixture(autouse=True)
def untuned():
    """Both packages untuned, so every knob resolves to its default."""
    prev_j, prev_t = jtuning._state.enabled, tuning.dispatch._state.enabled
    jtuning.set_enabled(False)
    tuning.set_enabled(False)
    yield
    jtuning.set_enabled(prev_j)
    tuning.set_enabled(prev_t)


@pytest.fixture(scope="module")
def graphs():
    base = jsyn(120, 200, 8, seed=7)
    return (jdelta.with_headroom(base, 0.25),
            tdelta.with_headroom(port_hin(base), 0.25))


def _services(graphs, **cfg):
    jhin, thin = graphs
    cfg = {**DISTILL, **cfg}
    js = JService(jcreate("numpy", jhin, jcompile("APVPA", jhin.schema)),
                  config=JConfig(**cfg))
    ts = PathSimService(
        create_backend("torch", thin, compile_metapath("APVPA", thin.schema),
                       device="cpu"),
        config=ServeConfig(**cfg))
    return js, ts


def _same(a, b):
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _write_pairs(path, rows, cols, scores):
    with open(path, "w", encoding="utf-8") as f:
        for r, c, s in zip(rows, cols, scores):
            f.write(json.dumps({"row": int(r), "col": int(c),
                                "score": float(s)}) + "\n")


def test_pairs_to_pool_equal_jax():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 60, 500)
    cols = rng.integers(0, 60, 500)
    scores = rng.choice([0.1, 0.25, 0.5], 500)  # ties on purpose
    for n, width in ((50, 8), (60, 3), (10, 16), (0, 4)):
        got = trainer._pairs_to_pool(rows, cols, scores, n, width)
        want = jtrainer._pairs_to_pool(rows, cols, scores, n, width)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_train_towers_hard_pool_and_info_equal_jax(graphs, tmp_path,
                                                   monkeypatch):
    """The pool train_towers installs — mined lists with the campaign's
    rows replacing theirs — and every deterministic info field."""
    jhin, thin = graphs
    ex = NeuralPathSim(thin, "APVPA", dim=8, hidden=16, device="cpu")
    exact = ex.exact_scores()
    rng = np.random.default_rng(1)
    rows = rng.choice(ex.n, 30, replace=False)
    pr, pc, ps = [], [], []
    for r in rows:
        for c in np.argsort(-exact[r], kind="stable")[1:6]:
            pr.append(r), pc.append(c), ps.append(exact[r, c])
    pairs = str(tmp_path / "pairs.jsonl")
    _write_pairs(pairs, pr, pc, ps)
    pools = {}
    for name, cls in (("jax", JNeural), ("port", NeuralPathSim)):
        orig = cls.set_hard_pool

        def capture(self, s, c, name=name, orig=orig):
            pools[name] = (np.array(s), np.array(c))
            orig(self, s, c)

        monkeypatch.setattr(cls, "set_hard_pool", capture)
    kw = dict(dim=8, hidden=16, steps=12, hard_sources=40, hard_k=6,
              hard_frac=0.75, pairs=pairs, val_frac=0.2, seed=3)
    _, jinfo = jtrainer.train_towers(jhin, "APVPA", **kw)
    enc, info = trainer.train_towers(thin, "APVPA", device="cpu", **kw)
    for a, b in zip(pools["port"], pools["jax"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert info.keys() == jinfo.keys()
    for key in ("n", "v", "dim", "hidden", "steps", "seed", "variant",
                "metapath", "pairs_total", "pairs_val", "hard_pool",
                "token"):
        assert info[key] == jinfo[key], key
    assert np.isfinite(info["final_loss"]) and info["val_score_corr"] > 0
    assert (enc.dim, enc.hidden, enc.v, enc.meta) == (8, 16, ex.v,
                                                      {"steps": 12,
                                                       "seed": 3})


def test_distilled_service_answers_bit_identically(graphs):
    """tests/test_learned.py:86 on the port, against the JAX service."""
    js, ts = _services(graphs)
    try:
        snap = ts.stats()["learned"]
        assert snap is not None and snap["enabled"]
        assert snap["token"] == list(ts.consistency_token)
        assert ts._learned.encoder.meta == {"steps": 40, "seed": 0}
        eligible = np.flatnonzero(np.asarray(ts._learned.d)[: ts.n] > 0)
        for row in eligible[:: max(eligible.size // 24, 1)]:
            got = ts.topk_index(int(row), k=7, mode="learned")
            assert _same(got, ts.topk_index(int(row), k=7, mode="exact"))
            assert _same(got, js.topk_index(int(row), k=7, mode="learned"))
    finally:
        js.close()
        ts.close()


def test_cold_start_with_distilled_towers(graphs):
    """tests/test_learned.py:188 on the port: a never-seen author is
    answered through 'stale' before the absorb and through the towers
    after it, bit-identical to the exact lane and to the JAX service."""
    js, ts = _services(graphs)
    try:
        n0 = ts.n
        papers = sorted({int(p) for p in np.random.default_rng(3).integers(
            0, graphs[0].type_size("paper"), 5)})
        for svc, dl in ((js, jdelta), (ts, tdelta)):
            info = svc.update(dl.DeltaBatch(
                nodes=(dl.NodeAppend(node_type="author", count=1),),
                edges=(dl.edge_delta("author_of",
                                     add=[[n0, p] for p in papers]),)))
            assert info["mode"] == "delta"
            assert info["learned_pending_appends"] == 1
        assert ts.learned_fallback_reason(n0, "learned") == "stale"
        before = ts.topk_index(n0, k=6, mode="learned")
        assert _same(before, ts.topk_index(n0, k=6, mode="exact"))
        assert _same(before, js.topk_index(n0, k=6, mode="learned"))
        refresh = ts.refresh_towers()
        jrefresh = js.refresh_towers()
        assert (refresh["appended"], refresh["stale_remaining"]) == (1, 0)
        assert refresh["refreshed"] == jrefresh["refreshed"]
        assert ts.learned_fallback_reason(n0, "learned") is None
        after = ts.topk_index(n0, k=6, mode="learned")
        assert _same(after, before)
        assert ts.stats()["learned"]["cold_start_ratio"] == 1.0
    finally:
        js.close()
        ts.close()


def test_checkpoint_boot_and_retraining_on_rejection(graphs, tmp_path):
    """tests/test_learned.py:275 on the port: a service boots from the
    towers another distilled; a foreign checkpoint is refused and
    replaced by distillation; a later install whose graph the towers no
    longer match (a reload onto another graph) retrains — both packages
    alike."""
    jhin, thin = graphs
    donor = _services(graphs)[1]
    try:
        path = str(tmp_path / "towers.npz")
        save_towers(path, donor._learned.encoder, donor.consistency_token)
        want = donor.topk_index(1, k=5, mode="exact")
    finally:
        donor.close()
    foreign = str(tmp_path / "foreign.npz")
    save_towers(foreign, donor._learned.encoder, ("0123456789abcdef", 0))
    for ckpt, steps in ((path, 0), (foreign, 10)):
        js, ts = _services(graphs, learned_checkpoint=ckpt,
                           learned_steps=10)
        try:
            snap = ts.stats()["learned"]
            assert snap is not None and snap["enabled"]
            assert snap["token"] == list(ts.consistency_token)
            trained = ts._learned.encoder.meta.get("steps")
            assert trained == (40 if ckpt == path else steps)
            got = ts.topk_index(1, k=5, mode="learned")
            assert _same(got, want)
            assert _same(got, js.topk_index(1, k=5, mode="learned"))
        finally:
            js.close()
            ts.close()
    # the reload: another graph (one author_of edge fewer), the
    # checkpoint now foreign to it; the learned-mode service trains its
    # own towers
    block = jhin.blocks["author_of"]
    edge = [[int(block.rows[0]), int(block.cols[0])]]
    other_j = jdelta.apply_delta(jhin, jdelta.DeltaBatch(edges=(
        jdelta.edge_delta("author_of", remove=edge),)))[0]
    other_t = tdelta.apply_delta(thin, tdelta.DeltaBatch(edges=(
        tdelta.edge_delta("author_of", remove=edge),)))[0]
    js, ts = _services(graphs, learned_checkpoint=path, learned_steps=10)
    try:
        js.reload(jcreate("numpy", other_j, jcompile("APVPA",
                                                     other_j.schema)))
        ts.reload(create_backend("torch", other_t, compile_metapath(
            "APVPA", other_t.schema), device="cpu"))
        snap = ts.stats()["learned"]
        assert snap is not None and snap["enabled"]
        assert snap["token"] == list(ts.consistency_token)
        assert ts._learned.encoder.meta == {"steps": 10, "seed": 0}
        assert js.stats()["learned"] is not None
        for row in (0, 1, 5):
            got = ts.topk_index(row, k=5, mode="learned")
            assert _same(got, ts.topk_index(row, k=5, mode="exact"))
            assert _same(got, js.topk_index(row, k=5, mode="learned"))
    finally:
        js.close()
        ts.close()


def test_learned_cli_train_and_inspect(tmp_path, capsys):
    """tests/test_learned.py:444 on the port, JSON against the JAX CLI's."""
    from distributed_pathsim_tpu.cli import main as jmain
    from distributed_pathsim_tpu_torch.cli import main as tmain

    argv = ["learned", "train",
            "--dataset", "synthetic:authors=80,papers=140,venues=6,seed=3",
            "--steps", "15", "--dim", "8", "--hard-sources", "32",
            "--hard-k", "6"]
    out = {}
    for name, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--platform", "cpu"])):
        path = str(tmp_path / f"{name}.npz")
        assert main([*argv, "--out", path, *extra]) == 0
        info = json.loads(capsys.readouterr().out)
        assert main(["learned", "inspect", "--towers", path]) == 0
        out[name] = (info, json.loads(capsys.readouterr().out))
    (jinfo, jmeta), (info, meta) = out["jax"], out["port"]
    assert info.keys() == jinfo.keys() and info["dim"] == 8
    for key in info.keys() - {"final_loss", "train_s", "out"}:
        assert info[key] == jinfo[key], key
    assert meta.keys() == jmeta.keys() and meta["base_fp"] == \
        info["token"][0]
    for key in meta.keys() - {"towers"}:
        assert meta[key] == jmeta[key], key


def test_training_flags_through_serve_worker_router():
    """tests/test_learned.py:464 on the port: the router forwards the
    training flags as the JAX router does, and serve / worker read them
    into the same ServeConfig fields."""
    from distributed_pathsim_tpu.router.cli import (
        _worker_argv as j_worker_argv,
    )
    from distributed_pathsim_tpu.router.cli import (
        build_router_parser as j_router_parser,
    )
    from distributed_pathsim_tpu_torch.router.cli import (
        _worker_argv,
        parse_router_args,
        parse_worker_args,
    )
    from distributed_pathsim_tpu_torch.serving.cli import (
        parse_serve_args,
        serve_config,
    )

    flags = ["--workers", "2", "--topk-mode", "learned",
             "--learned-dim", "16", "--learned-steps", "7",
             "--learned-neg-ratio", "0.25", "--learned-cand-mult", "8",
             "--learned-checkpoint", "/tmp/towers.npz",
             "--no-learned-refresh"]
    argv = _worker_argv(parse_router_args(["--dataset", "g.gexf", *flags]),
                        0)
    jargv = j_worker_argv(j_router_parser().parse_args(
        ["--dataset", "g.gexf", *flags]), 0)

    def learned(a):
        return {tok: a[i + 1] if i + 1 < len(a) and not a[i + 1].startswith(
            "--") else True for i, tok in enumerate(a)
            if tok.startswith(("--learned", "--topk-mode",
                               "--no-learned"))}

    assert learned(argv) == learned(jargv)
    wargs = parse_worker_args(argv[argv.index("--worker-id"):])
    cfg = serve_config(parse_serve_args(["--dataset", "g.gexf",
                                         *flags[2:]]))
    for args in (wargs, cfg):
        assert (args.learned_dim, args.learned_steps,
                args.learned_neg_ratio) == (16, 7, 0.25)
    assert (ServeConfig().learned_steps, ServeConfig().learned_dim,
            ServeConfig().learned_neg_ratio) == (
        JConfig().learned_steps, JConfig().learned_dim,
        JConfig().learned_neg_ratio)
