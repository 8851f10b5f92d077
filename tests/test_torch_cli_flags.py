"""The batch-CLI flags this slice ports, each run as ``dpathsim-torch
--platform cpu`` against ``python -m distributed_pathsim_tpu.cli
--backend jax --platform cpu`` on one written synthetic GEXF: run logs
byte-identical apart from the ``***`` timing lines, ranking TSVs
byte-identical, the ``--explain-plan`` JSON equal, the ``--metrics``
JSONL event names and the ``--trace-out`` span names equal, and the
error probes' messages equal (backend names aside). The multi-metapath
mode's output is compared in tests/test_torch_multipath.py."""

import json

import pytest

from distributed_pathsim_tpu_torch.cli import main as torch_main
from distributed_pathsim_tpu_torch.obs.trace import (
    FACTOR_SPANS, FOLD_SPANS, RESULT_PATH_SPANS)
from torch_port_util import run_both_clis, write_cli_gexf


@pytest.fixture(scope="module")
def gexf(tmp_path_factory):
    return write_cli_gexf(tmp_path_factory.mktemp("flags") / "g.gexf")


@pytest.fixture(autouse=True)
def process_state(monkeypatch):
    """Undo what the CLIs leave process-wide: the tuning state, the
    exported PATHSIM_MAX_RETRIES and --trace-out's tracing switch."""
    from distributed_pathsim_tpu import obs as jobs
    from distributed_pathsim_tpu import tuning as jtuning
    from distributed_pathsim_tpu_torch import obs as tobs
    from distributed_pathsim_tpu_torch import tuning

    for var in ("PATHSIM_TUNING_TABLE", "PATHSIM_MAX_RETRIES"):
        # setenv first, so the undo restores the prior state even when
        # the variable was absent (delenv alone records nothing then)
        # and a value the CLI exports does not outlive the test
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)
    tracing = (jobs.get_tracer().enabled, tobs.get_tracer().enabled)
    yield
    tuning.reset()
    jtuning.reset()
    jobs.configure(tracing=tracing[0])
    tobs.configure(tracing=tracing[1])


def _grammar(path):
    with open(path, encoding="utf-8") as f:
        return [line for line in f if not line.startswith("***")]


def _log_and_ranking(gexf, tmp_path, capsys, extra, jextra=(), textra=()):
    """Both CLIs' single-source log (+ top-k listing) and rank-all TSV
    for ``extra``; asserts they agree and returns the port's outputs.
    Each call writes a directory of its own (the log is appended to)."""
    tmp_path = tmp_path / f"run{len(list(tmp_path.iterdir()))}"
    tmp_path.mkdir()
    j_log, t_log = str(tmp_path / "j.log"), str(tmp_path / "t.log")
    (rc_j, out_j, _), (rc_t, out_t, _) = run_both_clis(
        gexf, [*extra, "--source", "author_5", "--top-k", "6", "--quiet"],
        capsys, out_j=["--output", j_log, *jextra],
        out_t=["--output", t_log, *textra],
    )
    assert rc_j == rc_t == 0
    assert _grammar(t_log) == _grammar(j_log)
    assert out_t == out_j and "Top-6 similar to author_5:" in out_t
    j_tsv, t_tsv = tmp_path / "j.tsv", tmp_path / "t.tsv"
    (rc_j, _, _), (rc_t, _, _) = run_both_clis(
        gexf, [*extra, "--top-k", "7", "--quiet"], capsys,
        out_j=["--ranking-out", str(j_tsv), *jextra],
        out_t=["--ranking-out", str(t_tsv), *textra],
    )
    assert rc_j == rc_t == 0
    assert t_tsv.read_bytes() == j_tsv.read_bytes()
    return _grammar(t_log), t_tsv.read_bytes()


def test_dtype_float64_matches_jax_x64(gexf, tmp_path, capsys):
    """``--dtype float64`` (JAX under x64, the port's plain versions in
    float64): the same log and ranking; the all-pairs summary too."""
    log64, tsv64 = _log_and_ranking(gexf, tmp_path, capsys,
                                    ["--dtype", "float64"])
    log32, tsv32 = _log_and_ranking(gexf, tmp_path, capsys, [])
    assert log64 == log32  # the log's scores are host f64 either way
    assert tsv64 != tsv32  # rank-all values are f64 now, not f32
    (rc_j, out_j, _), (rc_t, out_t, _) = run_both_clis(
        gexf, ["--dtype", "float64", "--all-pairs", "--quiet"], capsys)
    assert rc_j == rc_t == 0 and out_t == out_j
    assert "All-pairs scores: 350x350" in out_t


@pytest.mark.parametrize("extra", [
    ["--headroom", "0.25"],
    ["--max-retries", "1", "--no-degrade"],
    ["--no-tuning"],
    ["--tuning-table", "/nonexistent/table.json"],
    ["--loader", "native"],
])
def test_flags_keep_log_and_ranking_identical(gexf, tmp_path, capsys, extra):
    _log_and_ranking(gexf, tmp_path, capsys, extra)


def test_tuning_table_fallback_and_sparse_factor_format(gexf, tmp_path,
                                                        capsys):
    """An absent table: both CLIs fall back to heuristics with one
    ``tuning_fallback`` event naming it; ``--factor-format coo`` on the
    streaming backends gives the same ranking."""
    tbl = str(tmp_path / "absent.json")
    j_m, t_m = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    (rc_j, _, err_j), (rc_t, _, err_t) = run_both_clis(
        gexf, ["--tuning-table", tbl, "--top-k", "3", "--quiet"], capsys,
        out_j=["--metrics", str(j_m)], out_t=["--metrics", str(t_m)])
    assert rc_j == rc_t == 0
    for err, m in ((err_j, j_m), (err_t, t_m)):
        assert err.count("[pathsim:tuning_fallback]") == 1 and "absent" in err
        events = [json.loads(line)["event"] for line in m.open()]
        assert events.count("tuning_fallback") == 1
    _log_and_ranking(gexf, tmp_path, capsys, ["--factor-format", "coo"],
                     jextra=["--backend", "jax-sparse"],
                     textra=["--backend", "torch-sparse"])


def test_explain_plan_json_equal(gexf, capsys):
    for spec in ("APVPA", "APVPA,APTPA,APA"):
        (rc_j, out_j, _), (rc_t, out_t, _) = run_both_clis(
            gexf, ["--explain-plan", "--metapath", spec], capsys)
        assert rc_j == rc_t == 0
        got, want = json.loads(out_t), json.loads(out_j)
        assert got == want and sorted(got) == sorted(spec.split(","))


def test_observability_outputs_match(gexf, tmp_path, capsys):
    """``--metrics`` JSONL event names, ``--trace-out`` span names (the
    ``stage:*`` spans under ``driver.run_single_source``) and the
    ``--metrics-file`` families agree; ``--profile-dir`` writes a
    torch.profiler Chrome trace that parses."""
    out = {}
    for side in ("j", "t"):
        out[side] = {k: tmp_path / f"{side}.{k}"
                     for k in ("jsonl", "trace.json", "prom")}
    prof = tmp_path / "prof"
    (rc_j, _, _), (rc_t, _, _) = run_both_clis(
        gexf, ["--source", "author_5", "--quiet"], capsys,
        out_j=["--metrics", str(out["j"]["jsonl"]), "--trace-out",
               str(out["j"]["trace.json"]), "--metrics-file",
               str(out["j"]["prom"])],
        out_t=["--metrics", str(out["t"]["jsonl"]), "--trace-out",
               str(out["t"]["trace.json"]), "--metrics-file",
               str(out["t"]["prom"]), "--profile-dir", str(prof)],
    )
    assert rc_j == rc_t == 0
    seen = {}
    for side, files in out.items():
        events = [json.loads(line)["event"] for line in files["jsonl"].open()]
        trace = json.loads(files["trace.json"].read_text())["traceEvents"]
        spans = {e["name"]: e for e in trace if e.get("ph") == "X"}
        families = {line.split()[2] for line in files["prom"].open()
                    if line.startswith("# TYPE")}
        seen[side] = (events, sorted(spans), families)
        root = spans["driver.run_single_source"]
        for stage in ("device_denominators", "device_pairwise_row",
                      "emit_log"):
            span = spans[f"stage:{stage}"]
            assert root["ts"] <= span["ts"]
            assert span["ts"] + span["dur"] <= root["ts"] + root["dur"]
    # the port also spans its backends' fold and factor build, where the
    # JAX package records none: those names are the port's alone
    own = {*FOLD_SPANS, *FACTOR_SPANS, *RESULT_PATH_SPANS, "backend.tile"}
    t_events, t_spans = seen["t"][:2]
    assert (t_events, [n for n in t_spans if n not in own]) == seen["j"][:2]
    assert {"backend.fold", "backend.factor"} <= set(t_spans)
    assert "source_global_walk" in seen["t"][0]
    # the registries are process-wide (earlier tests add families)
    for family in ("dpathsim_stage_seconds", "dpathsim_plan_builds_total",
                   "dpathsim_tuning_lookups_total",
                   "dpathsim_backend_inits_total"):
        assert family in seen["t"][2] and family in seen["j"][2]
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def _norm(msg: str) -> str:
    for a, b in (("jax-sparse", "torch-sparse"), ("jax scorer", "torch scorer"),
                 ("(jax, torch-sparse)", "(torch, torch-sparse)")):
        msg = msg.replace(a, b)
    return msg


def test_error_probes_identical(gexf, capsys):
    probes = [
        ["--metapath", "APVPA,APA", "--weights", "1,2,3", "--top-k", "3"],
        ["--metapath", "APVPA,APA", "--output", "x.log", "--top-k", "3"],
        ["--metapath", "APVPA,APA", "--source", "nobody at all"],
        ["--factor-format", "coo", "--top-k", "3"],
        ["--tile-rows", "64", "--top-k", "3"],
        ["--dtype", "float64", "--explain-plan", "--metapath", "APXPA"],
        ["--num-processes", "2", "--top-k", "3"],
    ]
    for extra in probes:
        (rc_j, _, err_j), (rc_t, _, err_t) = run_both_clis(gexf, extra,
                                                           capsys)
        assert rc_j == rc_t == 1, extra
        last_t = err_t.splitlines()[-1]
        assert last_t.startswith("error: "), extra
        assert last_t == _norm(err_j.splitlines()[-1]), extra
    # --n-devices runs with the sharded backend and is refused beside any
    # other (the JAX CLI ignores it there); the packed layouts run
    # (tests/test_torch_packed_sparse.py)
    assert torch_main(["--dataset", gexf, "--platform", "cpu",
                       "--n-devices", "2", "--top-k", "3"]) == 1
    assert "requires --backend torch-sharded" in capsys.readouterr().err
    assert torch_main(["--dataset", gexf, "--platform", "cpu", "--backend",
                       "torch-sharded", "--n-devices", "2", "--top-k", "3",
                       "--quiet"]) == 0
    assert torch_main(["--dataset", gexf, "--platform", "cpu", "--backend",
                       "torch-sparse", "--factor-format", "bitpacked",
                       "--top-k", "3", "--quiet"]) == 0
