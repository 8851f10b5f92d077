"""The port's analyzer, recompile safety (RS001–RS003), re-keyed to the
port's compile points (utils/compile_counter.KINDS): kernel builds and
library loads behind a compile cache, and CUDA-graph captures.

The JAX analyzer's RS rules are about jit traces, so their corpora are
the port's own (``tests/fixtures/analysis_torch/``): each bad corpus
gives exactly its one finding, each good corpus none."""

from __future__ import annotations

import pytest

from torch_analysis_util import (
    JAX_FIXTURES,
    PORT_FIXTURES,
    expected_rule,
    port_findings,
)

# the RS corpora of the port's fixtures (the DT002 torch corpora beside
# them are test_torch_analysis_determinism.py's)
_RS = sorted(p for p in PORT_FIXTURES.iterdir()
             if p.is_dir() and p.name.split("_")[1].startswith("rs"))


@pytest.mark.parametrize("case", _RS, ids=lambda p: p.name)
def test_rs_corpus(case, tmp_path):
    findings = port_findings(case, tmp_path)
    if case.name.startswith("good_"):
        assert findings == [], [f.render() for f in findings]
    else:
        assert [f.rule for f in findings] == [expected_rule(case.name)], [
            f.render() for f in findings]


def test_every_port_rule_has_a_bad_and_a_good_corpus():
    """Every rule of the port's catalog fires on a bad corpus and stays
    quiet on a good one: the RS rules on the port's corpora, every other
    rule on the JAX package's (whose findings the port's equal). The
    catalog keeps the JAX analyzer's rule ids, families and migration
    map."""
    from distributed_pathsim_tpu.analysis import registry as jax_registry
    from distributed_pathsim_tpu_torch.analysis.registry import (
        MIGRATED_RULES,
        PASS_FAMILIES,
        RULES,
    )

    def rules(root, prefix, rs):
        return {expected_rule(p.name) for p in root.iterdir()
                if p.is_dir() and p.name.startswith(prefix)
                and expected_rule(p.name).startswith("RS") == rs}

    for prefix in ("bad_", "good_"):
        covered = (rules(PORT_FIXTURES, prefix, True)
                   | rules(JAX_FIXTURES, prefix, False))
        assert covered == set(RULES), (prefix, set(RULES) ^ covered)
    assert set(RULES) == set(jax_registry.RULES)
    assert {r: d.pass_name for r, d in RULES.items()} == {
        r: d.pass_name for r, d in jax_registry.RULES.items()}
    assert PASS_FAMILIES == jax_registry.PASS_FAMILIES
    assert MIGRATED_RULES == jax_registry.MIGRATED_RULES
