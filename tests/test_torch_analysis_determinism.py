"""The port's analyzer, determinism (DT001–DT004).

On every DT corpus of ``tests/fixtures/analysis/`` the port's analyzer
gives the JAX analyzer's findings (tests/torch_analysis_util.py)."""

from __future__ import annotations

import pytest

from torch_analysis_util import (
    PORT_FIXTURES,
    assert_parity,
    corpora,
    port_findings,
)


@pytest.mark.parametrize("case", corpora("dt"), ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)



def test_torch_selection_in_serving_is_dt002(tmp_path):
    """DT002 also names the port's own selections in ``serving/`` and
    ``router/``: ``torch.topk``, ``torch.argsort`` and a provable
    tensor's ``.sort`` (the (descending score, ascending column) tie
    order lives in the ops/pathsim primitives); a list's ``.sort`` and a
    tensor's ``.tolist().sort()`` are not selections of a tensor. One
    test for both corpora keeps this file at ten tests (the
    ``--dist loadfile`` rule of ROADMAP.md §A)."""
    got = {
        case: [(f.rule, f.line, f.symbol, f.message.split("()")[0])
               for f in port_findings(PORT_FIXTURES / case, tmp_path)]
        for case in ("bad_dt002_torch", "good_dt002_torch")
    }
    assert got["bad_dt002_torch"] == [
        ("DT002", 7, "top_rows", "torch.topk"),
        ("DT002", 12, "order_by_score", "torch.argsort"),
        ("DT002", 18, "best_first", "Tensor.sort"),
    ]
    assert got["good_dt002_torch"] == []
