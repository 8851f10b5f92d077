"""Port parity: the learned tier's host pieces against the JAX package —
the inductive encoder (features and the tower forward), tower
checkpoints in both directions, their refusals, the closed fallback
taxonomy and the learned knobs, ``dpathsim-torch learned``, the router's
forwarding of the learned flags, and the tower artifact committed for
chip_smoke.py's learned phase.

The committed artifact (``distributed_pathsim_tpu_torch/learned/data/
towers_bench_shape.npz``) and the JAX reference recall chip_smoke.py
holds the port to are made by this file run as a script, on the CPU,
with the JAX package (the card machine has neither JAX nor flax)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_learned_checkpoint.py make
    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_learned_checkpoint.py recall

``make`` trains the towers with the JAX package's ``train_towers`` on the
graph the learned phase serves (the bench shape with serve's headroom)
and writes the artifact; ``recall`` prints the JAX package's mean score
recall@10 over the phase's query rows with that artifact and the default
knobs.
"""

import json
import pathlib
import sys

import numpy as np
import pytest

from distributed_pathsim_tpu.data import delta as jdelta
from distributed_pathsim_tpu.data.synthetic import synthetic_hin as jsyn
from distributed_pathsim_tpu.learned import (
    LEARNED_FALLBACK_REASONS as J_REASONS,
)
from distributed_pathsim_tpu.learned import LEARNED_SURFACE as J_SURFACE
from distributed_pathsim_tpu.learned import InductiveEncoder as JEncoder
from distributed_pathsim_tpu.learned import TowerMismatch as JMismatch
from distributed_pathsim_tpu.learned import load_towers as jload
from distributed_pathsim_tpu.learned import save_towers as jsave
from distributed_pathsim_tpu.serving.cache import (
    graph_fingerprint as jfingerprint,
)
from distributed_pathsim_tpu.tuning import registry as jregistry
from distributed_pathsim_tpu_torch.learned import (
    LEARNED_FALLBACK_REASONS,
    LEARNED_SURFACE,
    InductiveEncoder,
    TowerMismatch,
    load_towers,
    save_towers,
    train_towers,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
ARTIFACT = (REPO / "distributed_pathsim_tpu_torch" / "learned" / "data"
            / "towers_bench_shape.npz")
# chip_smoke.py's learned phase: the bench graph (bench.py's shape, ids
# materialized as the main path writes its GEXF) with serve's default
# headroom; its query rows are 32 clients x 64 requests drawn as the
# ANN phase draws them, k = 10.
BENCH = dict(n_authors=32768, n_papers=45000, n_venues=384, seed=42,
             materialize_ids=True)
HEADROOM, ROWS_SEED, ROWS_SHAPE, TOP_K = 0.25, 42 + 11, (32, 64), 10
# the artifact's training: the JAX trainer's defaults but these
TRAIN = dict(dim=32, hidden=64, steps=60000, seed=0)


def _encoder(cls, v=12, hidden=24, dim=8, seed=3, meta=None):
    """A seeded encoder of either package (the same arrays)."""
    rng = np.random.default_rng(seed)
    quad_t = np.geomspace(1e-3, 10.0, 12)
    f = v + 1 + quad_t.size
    shapes = ((f, hidden), (hidden, hidden), (hidden, dim))
    layers = [((rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32),
               (rng.standard_normal(s[1]) * 0.1).astype(np.float32))
              for s in shapes]
    return cls(layers=layers, quad_t=quad_t, quad_w=quad_t * 0.5,
               deg_denom=4.25, target_scale=1.5, variant="rowsum",
               metapath="APVPA", meta=dict(meta or {"steps": 7, "seed": 3}))


def _rows(v, n=64, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, (n, v)).astype(np.float64)
    c[:3] = 0.0  # degenerate rows: zero C, zero d
    d = c @ c.sum(axis=0)
    return c, d


def test_features_and_embed_equal_jax():
    enc, jenc = _encoder(InductiveEncoder), _encoder(JEncoder)
    assert (enc.v, enc.dim, enc.hidden) == (jenc.v, jenc.dim, jenc.hidden)
    c, d = _rows(enc.v)
    np.testing.assert_array_equal(enc.features(c, d), jenc.features(c, d))
    got = enc.embed(c, d, device="cpu")
    assert got.dtype.is_floating_point and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), jenc.embed(c, d), rtol=1e-6,
                               atol=1e-6)
    # the layers stay read-only, as in JAX
    with pytest.raises(ValueError):
        enc.layers[0][0][0, 0] = 1.0


def test_checkpoints_load_across_packages(tmp_path):
    """A port-written checkpoint loads in the JAX package and a
    JAX-written one in the port: equal arrays, meta and token, and the
    files' entries byte-identical."""
    enc, jenc = _encoder(InductiveEncoder), _encoder(JEncoder)
    token = ("feedc0de01234567", 3)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_towers(ours, enc, token)
    jsave(theirs, jenc, token)
    import zipfile

    with zipfile.ZipFile(ours) as a, zipfile.ZipFile(theirs) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    for path in (ours, theirs):
        a, ta = load_towers(path, expect_base_fp=token[0])
        b, tb = jload(path, expect_base_fp=token[0])
        assert ta == tb == token
        assert a.meta == b.meta and a.meta["steps"] == 7
        for (ka, ba), (kb, bb) in zip(a.layers, b.layers):
            np.testing.assert_array_equal(ka, kb)
            np.testing.assert_array_equal(ba, bb)
        for name in ("quad_t", "quad_w", "deg_denom", "target_scale",
                     "variant", "metapath"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert not list(tmp_path.glob("*.tmp*"))  # atomic: no tmp left


def test_mismatches_refused_with_the_jax_messages(tmp_path):
    enc = _encoder(InductiveEncoder)
    path = str(tmp_path / "towers.npz")
    save_towers(path, enc, ("feedc0de", 0))
    bad = tmp_path / "broken.npz"
    bad.write_bytes(open(path, "rb").read()[:100])

    def rewrite(name, **meta_changes):
        with np.load(path) as arrs:
            payload = {k: arrs[k] for k in arrs.files}
        meta = json.loads(payload["meta"].tobytes().decode())
        meta.update(meta_changes)
        payload["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        out = str(tmp_path / name)
        np.savez_compressed(out, **payload)
        return out

    cases = [
        (path, "0000000000000000"),
        (str(bad), None),
        (rewrite("schema.npz", schema_version=2), None),
        (rewrite("format.npz", feature_format="l2c-r03"), None),
    ]
    for p, fp in cases:
        with pytest.raises(TowerMismatch) as ours:
            load_towers(p, expect_base_fp=fp)
        with pytest.raises(JMismatch) as theirs:
            jload(p, expect_base_fp=fp)
        assert str(ours.value) == str(theirs.value), p
    with pytest.raises(FileNotFoundError):
        load_towers(str(tmp_path / "missing.npz"))


def test_width_change_refused_all_or_nothing():
    """A contraction-width change is reported, never mis-embedded, and
    absorb raises before any state moves."""
    from distributed_pathsim_tpu_torch.learned import LearnedState

    enc = _encoder(InductiveEncoder)
    with pytest.raises(ValueError, match="retrain"):
        enc.features(np.zeros((4, enc.v + 3)), np.ones(4))
    with pytest.raises(ValueError):
        _encoder(JEncoder).features(np.zeros((4, enc.v + 3)), np.ones(4))
    c, d = _rows(enc.v)
    state = LearnedState(enc, c, d, device="cpu", token=("fp", 0))
    try:
        state.mark_stale(np.arange(5, 9))
        state.note_appends(1)
        emb, snap = state._emb.clone(), state.snapshot()
        wide = np.zeros((c.shape[0] + 4, enc.v + 2))
        with pytest.raises(ValueError):
            state.absorb(wide, wide.sum(axis=1), ("fp", 1))
        assert state.snapshot() == snap and state.token == ("fp", 0)
        assert state.c64 is not None and state.c64.shape == c.shape
        assert bool((state._emb == emb).all()) and state.stale_count == 4
        acct = state.absorb(c, d, ("fp", 1))
        assert acct == {"re_embedded": 4, "appended": 1}
        assert state.stale_count == 0 and state.token == ("fp", 1)
    finally:
        state.close()


def test_closed_taxonomy_surface_and_knobs_equal_jax():
    from distributed_pathsim_tpu import tuning as jtuning
    from distributed_pathsim_tpu_torch import tuning

    assert LEARNED_FALLBACK_REASONS == J_REASONS
    assert set(LEARNED_FALLBACK_REASONS) == {
        "no_towers", "stale", "uncovered", "degenerate", "low_confidence",
        "metapath"}
    assert LEARNED_SURFACE == J_SURFACE == {"tower_sims", "raw_sims"}
    knobs = ("learned_dim", "learned_neg_ratio", "learned_cand_mult",
             "learned_refresh_deltas", "learned_conf_floor")
    for knob in knobs:
        assert tuning.KNOBS[knob].candidates({}) == \
            jregistry.KNOBS[knob].candidates({}), knob
        assert tuning.make_key(knob, "cpu", n=130) == jtuning.make_key(
            knob, "cpu", n=130)
    # the trainer is ported: the JAX signature, plus the device it runs on
    import inspect

    from distributed_pathsim_tpu.learned import train_towers as jtrain

    ours = list(inspect.signature(train_towers).parameters)
    assert ours == [*inspect.signature(jtrain).parameters, "device"]


def test_learned_cli_inspect_matches_jax_and_train_refused(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    from distributed_pathsim_tpu.cli import main as jmain
    from distributed_pathsim_tpu_torch.cli import main as torch_main

    path = str(tmp_path / "towers.npz")
    jsave(path, _encoder(JEncoder), ("abcdef0123456789", 2))
    assert jmain(["learned", "inspect", "--towers", path]) == 0
    want = capsys.readouterr().out
    assert torch_main(["learned", "inspect", "--towers", path]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["delta_seq"] == 2
    # train runs on the card unless asked for the CPU: without a card
    # the default refuses before anything is written, --platform cpu
    # trains and writes a checkpoint inspect reads
    train = ["learned", "train", "--dataset",
             "synthetic:authors=80,papers=140,venues=6,seed=3",
             "--out", str(tmp_path / "t.npz"), "--steps", "5", "--dim", "8",
             "--hard-sources", "16", "--hard-k", "4"]
    import torch

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        assert torch_main(train) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "t.npz").exists()
    assert torch_main([*train, "--platform", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert torch_main(["learned", "inspect", "--towers",
                       str(tmp_path / "t.npz")]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert (meta["dim"], meta["base_fp"], meta["meta"]["steps"]) == (
        8, info["token"][0], 5)
    assert torch_main(["learned", "inspect", "--towers",
                       str(tmp_path / "missing.npz")]) == 1


def test_router_forwards_the_learned_flags_to_workers():
    from distributed_pathsim_tpu_torch.router.cli import (
        _worker_argv,
        parse_router_args,
    )

    args = parse_router_args([
        "--dataset", "g.gexf", "--workers", "2", "--topk-mode", "learned",
        "--learned-cand-mult", "8", "--learned-checkpoint",
        "/data/towers.npz", "--learned-shadow-every", "16",
        "--learned-recall-floor", "0.95", "--no-learned-refresh",
    ])
    argv = _worker_argv(args, 0)
    for flag, val in (("--topk-mode", "learned"),
                      ("--learned-cand-mult", "8"),
                      ("--learned-checkpoint", "/data/towers.npz"),
                      ("--learned-shadow-every", "16"),
                      ("--learned-recall-floor", "0.95")):
        assert argv[argv.index(flag) + 1] == val, flag
    assert "--no-learned-refresh" in argv
    assert argv[argv.index("--worker-id") + 1] == "w0"
    # the worker parses what the router forwards
    from distributed_pathsim_tpu_torch.router.cli import parse_worker_args

    wargs = parse_worker_args(argv[argv.index("--worker-id"):])
    assert (wargs.learned_checkpoint, wargs.learned_recall_floor,
            wargs.no_learned_refresh) == ("/data/towers.npz", 0.95, True)
    # the training flags are ported: parsed, and forwarded as JAX's are
    argv = _worker_argv(parse_router_args([
        "--dataset", "g.gexf", "--topk-mode", "learned", "--learned-dim",
        "16", "--learned-steps", "5", "--learned-neg-ratio", "0.25"]), 1)
    for flag, val in (("--learned-dim", "16"), ("--learned-steps", "5"),
                      ("--learned-neg-ratio", "0.25")):
        assert argv[argv.index(flag) + 1] == val, flag
    wargs = parse_worker_args(argv[argv.index("--worker-id"):])
    assert (wargs.learned_dim, wargs.learned_steps,
            wargs.learned_neg_ratio) == (16, 5, 0.25)


# -- the committed artifact -------------------------------------------------


def _bench_graphs():
    """(JAX, port) encodings of the learned phase's graph."""
    from distributed_pathsim_tpu_torch.data import delta as tdelta
    from distributed_pathsim_tpu_torch.data.synthetic import synthetic_hin

    return (jdelta.with_headroom(jsyn(**BENCH), HEADROOM),
            tdelta.with_headroom(synthetic_hin(**BENCH), HEADROOM))


def test_committed_artifact_is_keyed_to_the_learned_phase_graph():
    from distributed_pathsim_tpu_torch.serving.cache import graph_fingerprint

    assert ARTIFACT.stat().st_size < 1 << 20
    jhin, thin = _bench_graphs()
    fp = graph_fingerprint(thin)
    assert fp == jfingerprint(jhin)
    enc, token = load_towers(str(ARTIFACT), expect_base_fp=fp)
    jenc, jtoken = jload(str(ARTIFACT), expect_base_fp=fp)
    assert token == jtoken == (fp, 0)
    assert (enc.dim, enc.hidden, enc.v, enc.metapath, enc.variant) == (
        TRAIN["dim"], TRAIN["hidden"], 480, "APVPA", "rowsum")
    assert enc.meta == jenc.meta
    assert (enc.meta["steps"], enc.meta["seed"]) == (TRAIN["steps"],
                                                     TRAIN["seed"])


# -- the script: the artifact and the JAX reference recall ------------------


def make_artifact(path=ARTIFACT) -> dict:
    """Train the learned phase's towers with the JAX package and write
    them (atomically) to ``path``; returns the trainer's info."""
    from distributed_pathsim_tpu.learned import train_towers as jtrain

    jhin = _bench_graphs()[0]
    path.parent.mkdir(parents=True, exist_ok=True)
    _, info = jtrain(jhin, "APVPA", token=(jfingerprint(jhin), 0),
                     out=str(path), **TRAIN)
    return info


def jax_recall(path=ARTIFACT) -> dict:
    """The JAX package's learned lane at its default knobs (cand_mult 16)
    over the learned phase's query rows, against the host f64 oracle:
    mean score recall@10 (the share of returned items scoring at least
    the oracle's 10th score) and how many answers cover the oracle's
    set."""
    from distributed_pathsim_tpu.index.build import (
        half_chain_and_denominators,
    )
    from distributed_pathsim_tpu.learned import LearnedState
    from distributed_pathsim_tpu.ops import pathsim
    from distributed_pathsim_tpu.ops.metapath import compile_metapath

    jhin = _bench_graphs()[0]
    c, d = half_chain_and_denominators(
        jhin, compile_metapath("APVPA", jhin.schema))
    n = jhin.type_size("author")
    rows = np.random.default_rng(ROWS_SEED).choice(
        np.flatnonzero(d[:n] > 0), ROWS_SHAPE).ravel()
    enc, token = jload(str(path), expect_base_fp=jfingerprint(jhin))
    state = LearnedState(enc, c, d, token=token)
    recall, covered = [], 0
    try:
        for lo in range(0, rows.size, 256):
            r = rows[lo:lo + 256]
            s = pathsim.score_rows(c[r] @ c[:n].T, d[r], d[:n], xp=np)
            s[np.arange(r.size), r] = -np.inf
            ov, oi = pathsim.topk_from_score_rows(s, TOP_K)
            handle = state.probe_batch(r)
            for b in range(r.size):
                v, i = state.answer_from_handle(handle, b, int(r[b]), TOP_K)
                want = ov[b][np.isfinite(ov[b])]
                recall.append(min(float(
                    (v[np.isfinite(v)] >= want.min()).sum()) / want.size,
                    1.0))
                covered += set(i[np.isfinite(v)].tolist()) == set(
                    oi[b][np.isfinite(ov[b])].tolist())
    finally:
        state.close()
    return {"recall_at_10": float(np.mean(recall)), "covered": covered,
            "answers": int(rows.size), "cand_mult": state.cand_mult}


if __name__ == "__main__":
    action = sys.argv[1] if len(sys.argv) > 1 else ""
    if action == "make":
        print(json.dumps(make_artifact(), indent=2))
    elif action == "recall":
        print(json.dumps(jax_recall(), indent=2))
    else:
        raise SystemExit(f"usage: {sys.argv[0]} make | recall")
