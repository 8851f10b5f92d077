"""The port's autotuner (``distributed_pathsim_tpu_torch.tuning.
autotuner``, ``.sweep``, ``utils/benchrunner``) against the JAX
package's: the estimator on the same numbers, ``SweepPoint.parse``, the
racers' arm names, choices and table keys under one fake clock for every
knob both packages measure on the CPU, the ANN recall gate's real
per-arm recalls, the learned racer's arm set and gate logic under one
fake recall, the kernel knobs' stripe widths changing no answer against
the Pallas kernels in interpret mode, the two decision points consulting
the table, and ``dpathsim-torch tune`` / ``tuning.sweep --smoke`` on the
CPU. The kernel knobs' arms run only on the card
(tests/test_torch_cuda_tune.py)."""

import filecmp
import json
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_pathsim_tpu import tuning as jtuning
from distributed_pathsim_tpu.ops import pallas_kernels as pk
from distributed_pathsim_tpu.tuning import autotuner as jat
from distributed_pathsim_tpu.utils import benchrunner as jbr
from distributed_pathsim_tpu_torch import tuning
from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.ops import cuda_kernels as ck
from distributed_pathsim_tpu_torch.ops import sparse as tsp
from distributed_pathsim_tpu_torch.tuning import autotuner as tat
from distributed_pathsim_tpu_torch.tuning import sweep as tsweep
from distributed_pathsim_tpu_torch.utils import benchrunner as tbr
from torch_port_util import write_cli_gexf

CPU = torch.device("cpu")
# The knobs both packages measure on the CPU (the kernel knobs and
# ring_kernel have no CPU arm in the port; the learned racer trains
# towers whose draws differ between the packages).
SHARED_KNOBS = ["sparse_tile_rows", "sparse_nnz_floor",
                "plan_density_cutover", "plan_memo_budget_mb",
                "factor_format", "compact_chain_len", "compact_headroom",
                "serve_buckets", "ann_nprobe", "ann_cand_mult",
                "ann_centroids", "ann_cluster_cap", "ann_probe_variant"]


@pytest.fixture(autouse=True)
def fresh_tuning(monkeypatch):
    monkeypatch.delenv(tuning.TUNING_TABLE_ENV, raising=False)
    tuning.reset()
    jtuning.reset()
    yield
    tuning.reset()
    jtuning.reset()


def _fake_ms(name: str) -> float:
    # serve_buckets is decided outright (outside the 5% noise floor), so
    # the warm times the two packages measure for real never decide
    fixed = {"pow2": 1.0, "coarse": 2.0}
    return fixed.get(name, 1.0 + (zlib.crc32(name.encode()) % 1000) / 100.0)


def _fake_time_interleaved(arms, reps, warmup=1):
    """One fixed table of per-arm times, whatever the arms do (they are
    not run)."""
    out = {}
    for name in arms:
        ms = _fake_ms(name)
        out[name] = {"reps": reps, "best_ms": ms, "median_ms": ms,
                     "median_of_best_ms": ms, "worst_ms": ms,
                     "times_ms": [ms] * max(reps, 1)}
    return out


@pytest.fixture
def fake_clock(monkeypatch):
    monkeypatch.setattr(jbr, "time_interleaved", _fake_time_interleaved)
    monkeypatch.setattr(tbr, "time_interleaved", _fake_time_interleaved)


def _without_device(table) -> dict:
    """Entries keyed without their device part: {key: (choice, arms)}."""
    out = {}
    for key, ent in table.entries.items():
        parts = key.split("|")
        out["|".join(parts[:1] + parts[2:])] = (ent.choice, ent.arms)
    return out


@pytest.mark.parametrize("samples", [
    {"a": [1.0, 1.1, 1.05, 3.0, 9.0, 1.02], "b": [1.3, 1.2, 1.25, 1.4,
                                                   1.21, 5.0]},
    {"x": [2.0, 2.0, 2.0, 2.0], "y": [2.0, 2.5, 1.5, 2.0], "z": [0.5]},
])
def test_benchrunner_matches_jax(samples):
    """The same numbers give the same outputs: the interleave order,
    median_of_best, summarize, the rotated timed order, paired_ratio,
    best_arm and noise_bound."""
    for ts in samples.values():
        assert tbr.median_of_best(ts) == jbr.median_of_best(ts)
        assert tbr.median_of_best(ts, 0.25) == jbr.median_of_best(ts, 0.25)
        assert tbr.summarize(ts) == jbr.summarize(ts)
        assert tbr.median(ts) == jbr.median(ts)
    for mod in (tbr, jbr):
        order: list[str] = []
        got = mod.interleave(
            {n: (lambda n=n: order.append(n) or len(order))
             for n in samples}, reps=3)
        timed: list[str] = []
        mod.time_interleaved({n: (lambda n=n: timed.append(n))
                              for n in samples}, reps=4, warmup=0)
        if mod is tbr:
            want = (order, got, timed)
        else:
            assert (order, got, timed) == want
    res = {n: {**jbr.summarize(ts), "times_ms": [t * 1e3 for t in ts]}
           for n, ts in samples.items()}
    names = list(res)
    if all(len(r["times_ms"]) == len(res[names[0]]["times_ms"])
           for r in res.values()):
        assert tbr.paired_ratio(res, names[0], names[1:]) == \
            jbr.paired_ratio(res, names[0], names[1:])
    with pytest.raises(ValueError):
        tbr.paired_ratio(res, names[0], [])
    assert tbr.best_arm(res) == jbr.best_arm(res)
    assert tbr.noise_bound(res) == jbr.noise_bound(res)
    assert tbr.noise_bound(res, 0.2) == jbr.noise_bound(res, 0.2)


def test_sweep_point_parse_matches_jax():
    for spec in ("8192x384", "4096X64x32768", " 12x3 ".strip()):
        assert dataclass_tuple(tat.SweepPoint.parse(spec)) == \
            dataclass_tuple(jat.SweepPoint.parse(spec))
    for bad in ("8192", "1x2x3x4"):
        with pytest.raises(ValueError) as te:
            tat.SweepPoint.parse(bad)
        with pytest.raises(ValueError) as je:
            jat.SweepPoint.parse(bad)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError):
        tat.SweepPoint.parse("axb")


def dataclass_tuple(p):
    return (p.n, p.v, p.nnz)


def test_racers_match_jax_under_a_fake_clock(fake_clock):
    """Every knob both packages measure on the CPU: the same entries
    (keys without the device), choices and arm names, per-arm recall
    and bytes included; unknown knobs raise in both."""
    points = [tat.SweepPoint(256, 48), tat.SweepPoint(384, 48, nnz=2048)]
    jt = jat.tune([jat.SweepPoint(p.n, p.v, p.nnz) for p in points],
                  knobs=SHARED_KNOBS, reps=2, max_batch=8)
    tt = tat.tune(points, knobs=SHARED_KNOBS, reps=2, max_batch=8,
                  device=CPU)
    je, te = _without_device(jt), _without_device(tt)
    assert sorted(te) == sorted(je)
    assert {k.split("|")[0] for k in te} == set(SHARED_KNOBS)
    for key in je:
        (jc, ja), (tc, ta) = je[key], te[key]
        assert tc == jc, key
        assert sorted(ta) == sorted(ja), key
        for arm in ja:
            if arm.endswith(("_recall", "_bytes")):
                assert ta[arm] == ja[arm], (key, arm)
    for mod, kw in ((tat, {"device": CPU}), (jat, {})):
        with pytest.raises(ValueError, match="unknown knob"):
            mod.tune(points, knobs=["no_such_knob"], **kw)
    # the JAX Pallas knobs have no port arm: unknown to the port's tune
    with pytest.raises(ValueError, match="unknown knob"):
        tat.tune(points, knobs=["scores_variant"], device=CPU)


def test_ann_recall_gate_matches_jax(fake_clock):
    """At a point where the recall floor excludes arms, the real
    per-arm recalls of ``bench_ann`` (index build, probe and host
    rerank on the CPU) equal the JAX package's, so the gate keeps the
    same arms."""
    tres = tat.bench_ann(tat.SweepPoint(600, 48), reps=1, device=CPU,
                         recall_floor=0.999)
    jres = jat.bench_ann(jat.SweepPoint(600, 48), reps=1,
                         recall_floor=0.999)
    assert sorted(tres) == sorted(jres)
    for knob, (jc, ja) in jres.items():
        tc, ta = tres[knob]
        assert tc == jc, knob
        assert {a: r["recall"] for a, r in ta.items()} == \
            {a: r["recall"] for a, r in ja.items()}, knob
    # the floor excluded an arm from both races (its recall is 0.9984)
    assert set(tres["ann_centroids"][1]) == {"cmult0.5", "cmult1.0"}


class _FakeState:
    """A learned state whose recall is fixed by its arm's parameters:
    ``miss`` of k answers below the oracle's k-th score on every fifth
    row (a fake recall the two packages share)."""

    def __init__(self, encoder, c, d, cand_mult=16, **kw):
        _, dim, neg = encoder
        self.miss = (int(dim < 32) + int(neg > 0.5)
                     + int(cand_mult < 16) + int(cand_mult > 32))

    def probe_batch(self, rows, k=None):
        return rows

    def answer_from_handle(self, handle, b, row, k):
        vals = np.full(k, 1e30)
        if int(row) % 5 == 0:
            vals[:self.miss] = -1.0
        return vals, np.arange(k)

    def close(self):
        pass


def test_learned_arm_set_and_gate_match_jax(fake_clock, monkeypatch):
    """The learned racer under one fake recall (the packages' towers
    start from different draws): the same arms pass the gate, the same
    choices, recalls and conf floor."""
    from distributed_pathsim_tpu.learned import serving as jls
    from distributed_pathsim_tpu.learned import trainer as jtr
    from distributed_pathsim_tpu_torch.learned import serving as tls
    from distributed_pathsim_tpu_torch.learned import trainer as ttr

    def fake_train(hin, spec, dim=32, hard_frac=0.5, **kw):
        return ("enc", dim, round(1.0 - hard_frac, 6)), {}

    for mod in (jtr, ttr):
        monkeypatch.setattr(mod, "train_towers", fake_train)
    for mod in (jls, tls):
        monkeypatch.setattr(mod, "LearnedState", _FakeState)
    jres = jat.bench_learned(jat.SweepPoint(300, 48), reps=1,
                             recall_floor=0.98)
    tres = tat.bench_learned(tat.SweepPoint(300, 48), reps=1, device=CPU,
                             recall_floor=0.98)
    assert set(tres) == set(jres) == set(tat._LEARNED_KNOBS)
    for knob, (jc, ja) in jres.items():
        tc, ta = tres[knob]
        assert tc == jc, knob
        assert {a: r.get("recall") for a, r in ta.items()} == \
            {a: r.get("recall") for a, r in ja.items()}, knob
    # the gate excluded the arms the fake made miss too often
    assert "dim16" not in tres["learned_dim"][1]
    assert set(tres["learned_cand_mult"][1]) == {"mult16", "mult32"}


def test_stripe_widths_change_no_answer():
    """Every width the kernel knobs can hand K1 and K3: the plain
    candidates at that width reduced by pass 2 equal the Pallas kernels
    in interpret mode, values and indices bit for bit."""
    rng = np.random.default_rng(7)
    n = 1100
    c = rng.integers(0, 3, (n, 24)).astype(np.float32)
    c[rng.random(n) < 0.05] = 0.0  # zero-degree rows
    d = c @ c.sum(0)
    tc, td = torch.from_numpy(c), torch.from_numpy(d)
    k = 10
    jv, ji = pk.fused_topk_twopass(jnp.asarray(c), jnp.asarray(d), k=k,
                                   interpret=True)
    widths = tuning.KNOBS["twopass_stripe_tiles"].candidates({})
    assert widths == [8, 16, 32, 64, 128, 256]
    for w in widths + [1, 3]:
        cv, cc = ck.topk_twopass_candidates_plain(tc, td, k, True,
                                                  stripe_tiles=w)
        fv, fc = tsp.chunked_row_topk(cv.view(n, -1), cc.view(n, -1), k)
        np.testing.assert_array_equal(np.asarray(jv), fv.numpy())
        np.testing.assert_array_equal(np.asarray(ji), fc.long().numpy())
    # K3: a 768-row tile against every column, n_true short of N; the
    # stripe widths the units candidates give at the config-5 tile shape
    # and at this one
    t0, t, n_true = 200, 768, n - 5
    ids = np.arange(t0, t0 + t, dtype=np.int32)
    jv, ji = pk.fused_topk_twopass_rect(
        jnp.asarray(c[t0:t0 + t]), jnp.asarray(c), jnp.asarray(d[t0:t0 + t]),
        jnp.asarray(d), jnp.asarray(ids), k=k, n_true_cols=n_true,
        interpret=True)
    units = tuning.KNOBS["rect_target_units"].candidates({})
    rect_widths = {ck._stripe_tiles_for_units(8192, 1 << 20, u)
                   for u in units} | {ck._stripe_tiles_for_units(t, n, u)
                                      for u in units} | {2}
    args = (tc[t0:t0 + t], tc, td[t0:t0 + t], td, torch.from_numpy(ids), k,
            n_true)
    for w in sorted(rect_widths):
        cv, cc = ck.topk_rect_candidates_plain(*args, stripe_tiles=w)
        fv, fc = tsp.chunked_row_topk(cv.view(t, -1), cc.view(t, -1), k)
        np.testing.assert_array_equal(np.asarray(jv), fv.numpy())
        np.testing.assert_array_equal(np.asarray(ji), fc.long().numpy())


def test_stripe_knobs_consult_the_table(monkeypatch):
    """An installed table gives a hit and the gates follow the tuned
    width; a tuned value the shape cannot take (wider than the factor,
    below 1, a candidate buffer over the budget) is a fallback lookup
    and the heuristic runs."""
    table = tuning.TuningTable("cpu")
    put = lambda knob, n, v, choice: table.put(  # noqa: E731
        tuning.make_key(knob, "cpu", n=n, v=v), choice)
    put("twopass_stripe_tiles", 8192, 64, 32)
    put("twopass_stripe_tiles", 2048, 64, 128)  # 16 column tiles only
    put("twopass_stripe_tiles", 32768, 384, 8)
    put("rect_target_units", 1 << 20, 64, 2048)
    put("rect_target_units", 4096, 64, 0)
    put("rect_target_units", 32768, 384, 2048)
    tuning.set_table(table, "test")
    stats = tuning.lookup_stats
    h0, f0 = stats().get("hit", 0), stats().get("fallback", 0)

    assert ck.twopass_stripe_tiles(8192, 64, 10, "cpu") == 32
    assert ck.candidate_bytes(8192, 10, 64, "cpu") == 8192 * 2 * 10 * 8
    assert stats()["hit"] == h0 + 2
    assert ck.twopass_stripe_tiles(2048, 64, 10, "cpu") == 1  # the heuristic
    assert stats()["fallback"] == f0 + 1
    assert ck.rect_stripe_tiles(8192, 1 << 20, 64, 10, "cpu") == 256
    assert ck.rect_candidate_bytes(1 << 20, 8192, 10, 64, "cpu") == \
        8192 * 32 * 10 * 8
    assert ck.rect_stripe_tiles(4096, 4096, 64, 10, "cpu") == \
        ck._stripe_tiles_for_units(4096, 4096, ck.RECT_TARGET_UNITS)
    assert stats()["fallback"] == f0 + 2
    # over the budget on a card: 32 stripes of K1 candidates pass 10 MB
    # where the heuristic's 2 fit; K3's 2048 units likewise. The CPU
    # runs no kernel and has no buffer, so it takes the tuned width
    monkeypatch.setattr(ck, "candidate_budget_bytes", lambda dev: 10 << 20)
    assert ck.twopass_stripe_tiles(32768, 384, 10, "cpu") == 8
    assert ck.twopass_stripe_tiles(32768, 384, 10, "cuda") == 128
    assert ck.candidate_bytes(32768, 10, 384, "cuda") == 32768 * 2 * 10 * 8
    assert ck.twopass_fits(32768, 10, "cuda", 384)
    assert ck.rect_stripe_tiles(32768, 32768, 384, 10, "cuda") == \
        ck._stripe_tiles_for_units(32768, 32768, ck.RECT_TARGET_UNITS)
    assert ck.rect_fits(32768, 32768, 10, "cuda", 384)
    assert stats()["fallback"] == f0 + 7
    # K1's plain candidates take the tuned width: 32 tiles, 2 stripes
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.integers(0, 2, (8192, 64)).astype(np.float32))
    cv, _ = ck.topk_twopass_candidates_plain(c, c.sum(1) + 1, 4, True)
    assert cv.shape == (8192, 2, 4)


def test_tune_cli_on_the_cpu(tmp_path, capsys):
    """``dpathsim-torch tune --platform cpu --quick`` writes a table the
    port loads (keyed 'cpu'); a rank-all under it (torch-sparse, whose
    tile height it retunes, and torch with a K1 width in the table) is
    cmp-identical to the untuned one; ``tune`` without ``--platform``
    refuses here, where there is no card."""
    table = tmp_path / "t.json"
    assert torch_main(["tune", "--platform", "cpu", "--quick",
                       "--out", str(table)]) == 0
    loaded = tuning.load_table(str(table), "cpu")
    assert loaded.device_kind == "cpu" and loaded.entries
    assert all(k.split("|")[1] == "cpu" for k in loaded.entries)
    assert not any(k.startswith(("twopass_stripe_tiles", "rect_target",
                                 "ring_kernel")) for k in loaded.entries)
    loaded.put(tuning.make_key("twopass_stripe_tiles", "cpu", n=300, v=20),
               1)
    loaded.save(str(table))
    gexf = write_cli_gexf(tmp_path / "g.gexf")
    for backend in ("torch-sparse", "torch"):
        outs = []
        for extra in ([], ["--tuning-table", str(table)]):
            tuning.reset()
            out = tmp_path / f"r_{backend}_{len(extra)}.tsv"
            assert torch_main(["--dataset", gexf, "--backend", backend,
                               "--platform", "cpu", "--top-k", "5",
                               "--ranking-out", str(out), *extra]) == 0
            outs.append(out)
        assert filecmp.cmp(*outs, shallow=False), backend
    capsys.readouterr()
    assert torch_main(["tune", "--out", str(tmp_path / "x.json")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.json").exists()


def test_sweep_smoke_on_the_cpu(tmp_path, capsys):
    """``python -m distributed_pathsim_tpu_torch.tuning.sweep --smoke
    --platform cpu``: the five checks pass; ``--bench`` refuses the
    host."""
    out = tmp_path / "smoke.json"
    assert tsweep.main(["--smoke", "--platform", "cpu",
                        "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert set(result["smoke_checks"]) == {
        "table_written_and_loaded", "hit_path_exercised",
        "corrupt_table_degrades", "fingerprint_mismatch_degrades",
        "zero_steady_state_compiles"}
    assert all(result["smoke_checks"].values())
    assert result["steady_state_compiles"] == 0
    capsys.readouterr()
    assert tsweep.main(["--bench", "--platform", "cpu"]) == 1
    assert "needs the card" in capsys.readouterr().err
