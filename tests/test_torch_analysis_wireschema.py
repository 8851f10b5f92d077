"""The port's analyzer, the wire-schema gate (WC101–WC103), and the
port's own schema file.

On every WC1 corpus of ``tests/fixtures/analysis/`` the port's analyzer
gives the JAX analyzer's findings (tests/torch_analysis_util.py). The
port gates against ``artifacts/wire_schema_torch.json``, written by
``dpathsim-torch lint --write-wire-schema``; it speaks the JAX wire, so
that file has the JAX schema's ops, field sets, ``response_complete``
and envelope, and the JAX package's ``artifacts/wire_schema.json`` is
never written."""

from __future__ import annotations

import hashlib
import json

import pytest

from torch_analysis_util import REPO, assert_parity, corpora

JAX_SCHEMA = REPO / "artifacts" / "wire_schema.json"
PORT_SCHEMA = REPO / "artifacts" / "wire_schema_torch.json"


@pytest.mark.parametrize("case", corpora("wc1"), ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)


def test_write_wire_schema_is_byte_stable_and_speaks_the_jax_wire(
        tmp_path, monkeypatch, capsys):
    """``--write-wire-schema`` regenerates the checked-in port schema
    byte for byte (written here to a scratch path, so a concurrent lint
    never reads a half-written file), and leaves the JAX package's
    schema as it is. The inferred schema has the JAX schema's ops, the
    same request and response field sets, the same required flags, the
    same ``response_complete`` and the same envelope."""
    from distributed_pathsim_tpu_torch.analysis import wireschema
    from distributed_pathsim_tpu_torch.analysis.cli import lint_main

    jax_before = hashlib.sha256(JAX_SCHEMA.read_bytes()).hexdigest()
    out = tmp_path / "wire_schema_torch.json"
    real, seen = wireschema.schema_path_for, []

    def to_scratch(modules):
        seen.append(real(modules))
        return out

    monkeypatch.setattr(wireschema, "schema_path_for", to_scratch)
    assert lint_main(["--write-wire-schema"]) == 0
    assert "(20 ops)" in capsys.readouterr().out
    assert seen == [PORT_SCHEMA]
    assert out.read_bytes() == PORT_SCHEMA.read_bytes()
    assert hashlib.sha256(JAX_SCHEMA.read_bytes()).hexdigest() == jax_before

    port, jax = json.loads(out.read_text()), json.loads(JAX_SCHEMA.read_text())
    assert port["envelope"] == jax["envelope"]
    assert sorted(port["ops"]) == sorted(jax["ops"])
    for op in jax["ops"]:
        p, j = port["ops"][op], jax["ops"][op]
        assert {f: s["required"] for f, s in p["request"].items()} == {
            f: s["required"] for f, s in j["request"].items()}, op
        assert set(p["response"]) == set(j["response"]), op
        assert p["response_complete"] == j["response_complete"], op
