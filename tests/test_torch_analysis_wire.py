"""The port's analyzer, the syntactic wire contract (WC001–WC004).

On every WC0 corpus of ``tests/fixtures/analysis/`` the port's analyzer
gives the JAX analyzer's findings (tests/torch_analysis_util.py)."""

from __future__ import annotations

import pytest

from torch_analysis_util import assert_parity, corpora


@pytest.mark.parametrize("case", corpora("wc0"), ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)
