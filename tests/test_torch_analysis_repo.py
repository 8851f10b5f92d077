"""The port's analyzer over the port: ``dpathsim-torch lint`` comes out
clean with the port's baseline and renders byte-identical JSON and SARIF
run to run; the baseline carries exactly the findings it names; the
parse cache keeps its contract by count; the CLI keeps the JAX
analyzer's surface and exit codes, and never builds a backend.

The whole-port analysis runs twice in this file: once raw (the module
fixture) and once through the CLI."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from torch_analysis_util import REPO


@pytest.fixture(scope="module")
def port_run():
    from distributed_pathsim_tpu_torch.analysis import (
        default_roots,
        load_modules,
        run_analysis,
    )

    modules = load_modules(default_roots())
    return {**run_analysis(modules=modules, baseline=None),
            "repo_rels": [m.repo_rel for m in modules]}


def test_port_lint_is_clean_and_byte_stable(port_run, tmp_path, capsys):
    """The walk is the port's package, ``chip_smoke.py`` and the port's
    own tests (not the JAX package's); with the baseline nothing is left;
    a second run through the CLI renders the same JSON and SARIF bytes."""
    from distributed_pathsim_tpu_torch.analysis import (
        RULES,
        load_baseline,
        render_json,
    )
    from distributed_pathsim_tpu_torch.analysis.cli import lint_main
    from distributed_pathsim_tpu_torch.analysis.core import apply_baseline
    from distributed_pathsim_tpu_torch.analysis.sarif import render_sarif

    pkg = [p.relative_to(REPO).as_posix() for p in sorted(
        (REPO / "distributed_pathsim_tpu_torch").rglob("*.py"))]
    tests = [p.relative_to(REPO).as_posix()
             for p in sorted((REPO / "tests").glob("test_torch_*.py"))]
    assert port_run["repo_rels"] == [*pkg, "chip_smoke.py", *tests]
    assert port_run["files"] == len(pkg) + len(tests) + 1 > 150

    kept, suppressed = apply_baseline(port_run["findings"], load_baseline())
    assert kept == [], "\n".join(f.render() for f in kept)
    result = {"findings": kept, "suppressed": suppressed,
              "files": port_run["files"]}
    sarif = tmp_path / "lint.sarif"
    assert lint_main(["--json", "--sarif", str(sarif)]) == 0
    assert capsys.readouterr().out == render_json(result) + "\n"
    text = sarif.read_text()
    assert text == render_sarif(result)
    doc = json.loads(text)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "dpathsim-torch-lint"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rule_ids == set(RULES) | {"BASELINE"}
    assert len(run["results"]) == len(suppressed)
    for r in run["results"]:
        assert r["suppressions"][0]["kind"] == "external"
        loc = r["locations"][0]["physicalLocation"]
        assert loc["region"]["startLine"] >= 1
        assert loc["artifactLocation"]["uri"]


def test_no_baseline_shows_exactly_the_baselined_findings(port_run, capsys):
    """Every raw finding is suppressed by an entry with a reason, every
    entry matches a finding (no stale, no expired one), the entries on
    code the port shares with the JAX package carry the JAX baseline's
    own, and ``--no-baseline`` exits 1 on what the baseline holds."""
    from distributed_pathsim_tpu.analysis.core import (
        load_baseline as jax_baseline,
    )
    from distributed_pathsim_tpu_torch.analysis import load_baseline
    from distributed_pathsim_tpu_torch.analysis.cli import lint_main
    from distributed_pathsim_tpu_torch.analysis.core import _entry_matches

    entries = load_baseline()
    raw = port_run["findings"]
    for f in raw:
        assert any(_entry_matches(e, f) for e in entries), f.render()
    for e in entries:
        assert str(e["reason"]).strip() and "expires" not in e
        assert any(_entry_matches(e, f) for f in raw), e
    assert {f.rule for f in raw} == {"LD002", "LD102", "LD103", "WC103"}
    mirrored = [
        {**e, "path": e["path"].replace("distributed_pathsim_tpu/",
                                        "distributed_pathsim_tpu_torch/")}
        for e in jax_baseline() if not e["path"].startswith("scripts/")
    ]
    assert len(mirrored) == 19
    assert all(e in entries for e in mirrored)
    capsys.readouterr()
    assert lint_main(["--no-baseline", "--rules", "WC103"]) == 1
    out = capsys.readouterr().out
    wc103 = [f for f in raw if f.rule == "WC103"]
    assert f"{len(wc103)} finding(s), 0 baselined" in out
    assert all(f.render() in out for f in wc103)


def test_cli_surface_and_exit_codes(capsys):
    """``--list-rules`` groups the catalog by family; an unknown rule or
    flag is a usage error (2); a rule filter applies only its rules'
    suppressions (0, clean)."""
    from distributed_pathsim_tpu_torch.analysis.cli import lint_main
    from distributed_pathsim_tpu_torch.analysis.registry import (
        PASS_FAMILIES,
        RULES,
    )

    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for family in PASS_FAMILIES.values():
        assert f"{family}:" in out
    for rid, doc in RULES.items():
        assert f"  {rid}  {doc.title}" in out
    assert "dpathsim-torch lint --rules" in out
    assert lint_main(["--rules", "NOPE"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        lint_main(["--no-such-flag"])
    assert exc.value.code == 2
    capsys.readouterr()
    assert lint_main(["--rules", "LD002,LD001"]) == 0
    assert "dpathsim-torch lint: 0 finding(s)" in capsys.readouterr().out


def test_lint_routes_through_the_port_cli_without_a_backend(monkeypatch,
                                                            capsys):
    """``dpathsim-torch lint`` is a subcommand of the port's CLI, and it
    builds no backend and creates no CUDA context."""
    import torch

    from distributed_pathsim_tpu_torch import cli, engine
    from distributed_pathsim_tpu_torch.backends import base

    def refuse(*_a, **_k):
        raise AssertionError("lint built a backend")

    monkeypatch.setattr(base, "create_backend", refuse)
    monkeypatch.setattr(engine, "build", refuse)
    assert "lint" in cli.SUBCOMMANDS
    assert cli.main(["lint", "--rules", "WC001"]) == 0
    assert "finding(s)" in capsys.readouterr().out
    assert not torch.cuda.is_initialized()


def test_parse_cache_contract_by_count(tmp_path):
    """A cold run parses every file, a warm one none, and touching one
    file re-parses exactly that one; the cached loader gives the
    uncached one's modules; the port's cache file is its own, apart
    from the JAX analyzer's."""
    import ast

    from distributed_pathsim_tpu.analysis import cache as jax_cache
    from distributed_pathsim_tpu_torch.analysis import load_modules
    from distributed_pathsim_tpu_torch.analysis.cache import (
        CACHE_REL,
        load_modules_cached,
    )

    assert CACHE_REL == ".lint_cache/parse_torch.pkl" != jax_cache.CACHE_REL
    pkg = tmp_path / "distributed_pathsim_tpu_torch"
    shutil.copytree(REPO / "distributed_pathsim_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    roots = {"package": pkg}
    cache = tmp_path / ".lint_cache" / "parse_torch.pkl"
    n = len(list(pkg.rglob("*.py")))

    stats = {}
    cold = load_modules_cached(roots, repo=tmp_path, cache_path=cache,
                               stats=stats)
    assert stats == {"parsed": n, "reused": 0} and cache.exists()
    warm = load_modules_cached(roots, repo=tmp_path, cache_path=cache,
                               stats=stats)
    assert stats == {"parsed": 0, "reused": n}
    plain = load_modules(roots, repo=tmp_path)
    for a, b in zip(warm, plain, strict=True):
        assert (a.repo_rel, a.rel, a.root_kind, a.text) == (
            b.repo_rel, b.rel, b.root_kind, b.text)
    assert [m.repo_rel for m in cold] == [m.repo_rel for m in warm]
    assert ast.dump(warm[-1].tree) == ast.dump(plain[-1].tree)

    touched = pkg / "analysis" / "core.py"
    st = touched.stat()
    os.utime(touched, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    load_modules_cached(roots, repo=tmp_path, cache_path=cache, stats=stats)
    assert stats == {"parsed": 1, "reused": n - 1}
