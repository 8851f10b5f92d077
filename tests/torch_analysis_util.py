"""Shared helpers of the port analyzer's tests (tests/test_torch_analysis_*.py).

The oracle is the JAX package's analyzer: on every corpus of
``tests/fixtures/analysis/`` but the recompile (RS) ones, the port's
analyzer must give the JAX analyzer's findings — the same rule, line,
symbol and message, with the package name and the wire-schema file
name rewritten. The RS rules are re-keyed to the port's compile points,
so their corpora are the port's own (``tests/fixtures/analysis_torch/``).
"""

from __future__ import annotations

import pathlib
import re
import shutil

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PORT_FIXTURES = REPO / "tests" / "fixtures" / "analysis_torch"

_JAX_SCHEMA = "wire_schema.json"
_PORT_SCHEMA = "wire_schema_torch.json"
_PKG = re.compile(r"distributed_pathsim_tpu(?!_torch)")


def corpora(*families: str) -> list[pathlib.Path]:
    """The JAX corpora of the given rule families (``"ld0"`` takes
    ``bad_ld001`` … ``good_ld002``), sorted; never an RS corpus."""
    out = []
    for p in sorted(JAX_FIXTURES.iterdir()):
        if not p.is_dir():
            continue
        family = p.name.split("_", 1)[1]
        if family.startswith("rs"):
            continue
        if family.startswith(families):
            out.append(p)
    return out


def expected_rule(case_name: str) -> str:
    # bad_rs002_pad -> RS002
    return case_name.split("_")[1].upper()


def jax_findings(case: pathlib.Path) -> list:
    from distributed_pathsim_tpu.analysis import load_modules, run_analysis

    modules = load_modules({"package": case}, repo=case)
    return run_analysis(modules=modules, repo=case)["findings"]


def port_findings(case: pathlib.Path, tmp_path: pathlib.Path) -> list:
    """The port's findings on a corpus. A corpus that carries the JAX
    schema file is copied with it renamed to the port's name (the port
    gates against ``artifacts/wire_schema_torch.json``); the fixture
    tree itself is never written."""
    from distributed_pathsim_tpu_torch.analysis import (
        load_modules,
        run_analysis,
    )

    if (case / "artifacts" / _JAX_SCHEMA).exists():
        copy = tmp_path / case.name
        shutil.copytree(case, copy)
        (copy / "artifacts" / _JAX_SCHEMA).rename(
            copy / "artifacts" / _PORT_SCHEMA)
        case = copy
    modules = load_modules({"package": case}, repo=case)
    assert modules, f"corpus {case.name} has no parsable files"
    return run_analysis(modules=modules, repo=case)["findings"]


def _key(f, rewrite: bool) -> tuple:
    path, message = f.path, f.message
    if rewrite:
        path = path.replace(_JAX_SCHEMA, _PORT_SCHEMA)
        message = _PKG.sub("distributed_pathsim_tpu_torch", message)
        message = message.replace(_JAX_SCHEMA, _PORT_SCHEMA)
    return (path, f.line, f.rule, f.symbol, message, f.severity)


def assert_parity(case: pathlib.Path, tmp_path: pathlib.Path) -> None:
    """The port's findings on ``case`` equal the JAX analyzer's, and
    they keep the corpus's own contract: a bad corpus gives exactly its
    one finding, a good corpus none."""
    want = [_key(f, True) for f in jax_findings(case)]
    got = [_key(f, False) for f in port_findings(case, tmp_path)]
    assert got == want
    if case.name.startswith("bad_"):
        assert [g[2] for g in got] == [expected_rule(case.name)], got
    else:
        assert got == [], got
