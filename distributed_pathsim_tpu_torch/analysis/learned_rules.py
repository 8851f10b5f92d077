"""Learned-doorway pass: raw tower scores stay behind the rerank.

- **LN001 tower-scores-reached-outside-the-learned-doorway**: the
  learned tier's raw tower similarities (``tower_sims`` /
  ``ProbeHandle.raw_sims``, learned/serving.py, DESIGN.md §32) are
  approximations in a score-LIKE scale — an operator (or any host
  boundary: protocol result, cache, metric, log) reading them as
  PathSim scores would be silently wrong in score units, which is
  exactly the failure the learned arm's safety story exists to
  exclude. Every served answer must leave through
  ``LearnedState.answer_from_handle``, which exact-f64 reranks inside
  ``learned/``. The surface registry is a frozenset literal parsed out
  of learned/serving.py (the CF001/BT001 pattern), so the rule and the
  code cannot drift; only modules inside ``learned/`` may unwrap the
  handle.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, qualname_index, symbol_at
from .wire import _frozenset_literal

RULE_DOCS = {
    "LN001": (
        "raw tower scores reached outside the learned doorway",
        "tower similarities are approximate shortlist scores, not "
        "PathSim scores; every answer must be exact-f64 reranked "
        "inside learned/ (LearnedState.answer_from_handle) before it "
        "reaches a host boundary — unwrap the probe handle only in "
        "learned/ modules",
    ),
}

_ENGINE = "learned/serving.py"
# the sanctioned callers: the learned package itself (the rerank
# doorway lives there, and the trainer/bench read raw predictions to
# MEASURE the towers, never to serve them)
_ALLOWED_PREFIX = "learned/"


class LearnedDoorwayPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        pkg = [m for m in modules if m.root_kind == "package"]
        surface = None
        for m in pkg:
            if m.rel == _ENGINE:
                surface = _frozenset_literal(m.tree, "LEARNED_SURFACE")
                break
        if not surface:
            return []  # no learned tier in this tree (fixture corpora)
        findings: list[Finding] = []
        for m in pkg:
            if m.rel.startswith(_ALLOWED_PREFIX):
                continue
            index = None
            for node in m.nodes:
                if (
                    isinstance(node, ast.Attribute)
                    and node.attr in surface
                ):
                    if index is None:
                        index = qualname_index(m.tree)
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="LN001",
                        symbol=symbol_at(index, node.lineno),
                        message=(
                            f".{node.attr} reached outside the learned "
                            "doorway — raw tower similarities are "
                            "approximate shortlist scores; serve "
                            "answers only through LearnedState."
                            "answer_from_handle (exact f64 rerank "
                            "inside learned/)"
                        ),
                    ))
        return findings
