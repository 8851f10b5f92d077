"""The port's analyzer, lock discipline within a class (LD001, LD002),
and the baseline's semantics.

On every LD0 corpus of ``tests/fixtures/analysis/`` the port's analyzer
gives the JAX analyzer's findings (tests/torch_analysis_util.py)."""

from __future__ import annotations

import ast
import datetime
import json
import pathlib

import pytest

from torch_analysis_util import assert_parity, corpora


@pytest.mark.parametrize("case", corpora("ld0"), ids=lambda p: p.name)
def test_corpus_gives_the_jax_findings(case, tmp_path):
    assert_parity(case, tmp_path)


def test_baseline_suppression_expiry_and_staleness():
    from distributed_pathsim_tpu_torch.analysis.core import (
        Finding,
        apply_baseline,
    )

    f = Finding(
        path="pkg/x.py", line=3, rule="LD002", symbol="A.peek",
        message="read of self.count without holding self._lock",
    )
    today = datetime.date(2026, 8, 4)
    entry = {"rule": "LD002", "path": "pkg/x.py", "match": "self.count",
             "reason": "racy by design"}
    # a live entry suppresses
    assert apply_baseline([f], [entry], today=today) == ([], [f])
    # an expired one stops suppressing AND reports itself
    kept, supp = apply_baseline(
        [f], [{**entry, "expires": "2026-01-01"}], today=today)
    assert supp == [] and sorted(k.rule for k in kept) == ["BASELINE",
                                                           "LD002"]
    assert any("expired" in k.message for k in kept)
    # an entry matching nothing is a stale-suppression error
    kept, _ = apply_baseline(
        [], [{"rule": "WC003", "path": "pkg/gone.py", "reason": "moved"}],
        today=today)
    assert [k.rule for k in kept] == ["BASELINE"]
    assert "stale suppression" in kept[0].message
    # symbol narrows the match
    kept, _ = apply_baseline(
        [f], [{"rule": "LD002", "path": "pkg/x.py", "symbol": "A.other",
               "reason": "different method"}], today=today)
    assert f in kept and any(k.rule == "BASELINE" for k in kept)


def test_baseline_requires_reason(tmp_path):
    from distributed_pathsim_tpu_torch.analysis import load_baseline

    p = tmp_path / "baseline.json"
    p.write_text(json.dumps(
        {"suppressions": [{"rule": "LD001", "path": "x.py"}]}))
    with pytest.raises(ValueError, match="reason"):
        load_baseline(p)


def test_interprocedural_entry_held_is_conservative():
    """A PUBLIC method never inherits caller lock facts (its external
    callers are unknown); a private one does — as in the JAX analyzer."""
    from distributed_pathsim_tpu_torch.analysis.core import Module
    from distributed_pathsim_tpu_torch.analysis.interlocks import (
        InterLockPass,
    )

    src = (
        "import queue\nimport threading\n\n\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._q = queue.Queue()\n"
        "        self.state = 0\n\n"
        "    def tick(self):\n"
        "        with self._lock:\n"
        "            self.state += 1\n"
        "            self.fetch()\n\n"
        "    def fetch(self):\n"
        "        return self._q.get()\n\n"
        "    def _locked_fetch(self):\n"
        "        return self._q.get()\n\n"
        "    def tock(self):\n"
        "        with self._lock:\n"
        "            self.state += 1\n"
        "            self._locked_fetch()\n"
    )
    m = Module(
        path=pathlib.Path("svc.py"), rel="svc.py", repo_rel="svc.py",
        root_kind="package", text=src, tree=ast.parse(src),
    )
    rules = sorted((f.rule, f.symbol) for f in InterLockPass().run([m]))
    assert ("LD102", "Svc._locked_fetch") in rules or (
        "LD102", "Svc.tock") in rules
    assert not any(sym == "Svc.fetch" for _r, sym in rules), rules
