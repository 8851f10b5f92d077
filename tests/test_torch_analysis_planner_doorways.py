"""The port's analyzer, the learned, metapath-planner and partition
doorways (LN001, MP001, PT001).

On every LN, MP and PT corpus of ``tests/fixtures/analysis/`` the port's
analyzer gives the JAX analyzer's findings
(tests/torch_analysis_util.py)."""

from __future__ import annotations

import pytest

from torch_analysis_util import assert_parity, corpora


@pytest.mark.parametrize("case", corpora("ln", "mp", "pt"),
                         ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)
