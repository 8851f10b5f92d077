"""Batch-doorway pass: block-sweep scoring stays behind the campaign.

- **BT001 block-sweep-reached-outside-the-batch-doorway**: the batch
  engine's block primitives (``sweep_topk_block`` / ``sweep_scores_block``
  / ``sweep_pair_block``, batch/campaign.py, DESIGN.md §31) compute
  correct bytes anywhere — but only the campaign runners wrap them in
  the checkpoint manifest (content-addressed on the graph identity),
  the stale-graph fence, the preemption checks, and the batch metrics.
  A module that calls a sweep primitive directly produces results no
  manifest owns: un-resumable after SIGTERM, un-fenced against a delta
  landing mid-sweep, and invisible to the campaign progress gauges.
  The surface registry is a frozenset literal parsed out of
  batch/campaign.py (the CF001/CP001 pattern), so the rule and the
  code cannot drift; batch/simjoin.py is the one sanctioned caller
  outside the engine module itself.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, qualname_index, symbol_at
from .wire import _frozenset_literal

RULE_DOCS = {
    "BT001": (
        "block-sweep scoring reached outside the batch doorway",
        "the sweep primitives are only resumable/fenced/metered inside "
        "a campaign runner (run_topk_campaign / run_simjoin_campaign); "
        "calling them elsewhere yields results no checkpoint manifest "
        "owns and no stale-graph fence protects — run a campaign, or "
        "dispatch the 'batch_blocks' protocol op",
    ),
}

_ENGINE = "batch/campaign.py"
# the sanctioned callers: the engine module and the simjoin runner
_ALLOWED = frozenset({
    "batch/campaign.py",
    "batch/simjoin.py",
})


class BatchDoorwayPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        pkg = [m for m in modules if m.root_kind == "package"]
        surface = None
        for m in pkg:
            if m.rel == _ENGINE:
                surface = _frozenset_literal(m.tree, "BATCH_SURFACE")
                break
        if not surface:
            return []  # no batch tier in this tree (fixture corpora)
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
                        path=m.repo_rel, line=node.lineno, rule="BT001",
                        symbol=symbol_at(index, node.lineno),
                        message=(
                            f".{node.attr} reached outside the batch "
                            "doorway — sweep results are only "
                            "checkpointed, fenced, and metered inside "
                            "a campaign runner; use run_topk_campaign/"
                            "run_simjoin_campaign (or the "
                            "'batch_blocks' protocol op)"
                        ),
                    ))
        return findings
