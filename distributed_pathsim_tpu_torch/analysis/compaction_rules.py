"""Compaction-doorway pass: the hot-swap stays behind the service.

- **CP001 compaction-swap-reached-outside-the-service-doorway**: a
  compaction swap (serving/compact.py, DESIGN.md §30) preserves the
  consistency token, the chained fingerprint, the per-row cache
  versions, and both cache tiers — invariants that hold ONLY because
  :meth:`PathSimService._apply_compaction` performs the whole sequence
  (token re-check, mid-build delta replay, pipeline drain, install)
  atomically under the swap lock. A module that reaches
  ``_apply_compaction``/``_swap_compacted`` from anywhere else can
  install a backend whose graph lags the live delta chain, or swap
  without draining — serving stale rows with a CURRENT token, which no
  fencing layer can catch. The surface registry is a frozenset literal
  parsed out of serving/service.py (the PT001/CF001 pattern), so the
  rule and the code cannot drift; serving/compact.py is the one
  sanctioned caller.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, qualname_index, symbol_at
from .wire import _frozenset_literal

RULE_DOCS = {
    "CP001": (
        "compaction swap reached outside the service doorway",
        "the compaction hot-swap's invariants (token/fingerprint/cache "
        "preservation, mid-build delta replay, drain-before-install) "
        "hold only inside PathSimService._apply_compaction under the "
        "swap lock; reaching the swap internals from anywhere but "
        "serving/compact.py can install a stale backend behind a "
        "current consistency token — serve compaction through "
        "service.compact() / the 'compact' protocol op instead",
    ),
}

_SERVICE = "serving/service.py"
# the sanctioned caller: the background builder itself
_ALLOWED = frozenset({
    "serving/service.py",
    "serving/compact.py",
})


class CompactionDoorwayPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        pkg = [m for m in modules if m.root_kind == "package"]
        surface = None
        for m in pkg:
            if m.rel == _SERVICE:
                surface = _frozenset_literal(m.tree, "COMPACTION_SURFACE")
                break
        if not surface:
            return []  # no compaction layer in this tree (fixture corpora)
        findings: list[Finding] = []
        for m in pkg:
            if m.rel in _ALLOWED:
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
                        path=m.repo_rel, line=node.lineno, rule="CP001",
                        symbol=symbol_at(index, node.lineno),
                        message=(
                            f".{node.attr} reached outside the service "
                            "doorway — the compaction swap is only "
                            "sound inside _apply_compaction under the "
                            "swap lock; use service.compact() (or the "
                            "'compact' protocol op)"
                        ),
                    ))
        return findings
