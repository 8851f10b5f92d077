"""Partition-ownership pass: factor rows stay behind the exchange layer.

- **PT001 factor-slice-read-outside-exchange-layer**: the partitioned
  fleet's correctness rests on one invariant — a worker computes ONLY
  with factor rows it owns, and everything else arrives over the wire
  ops (``tile_pull`` / ``partial_*`` / ``set_colsum``). The raw
  held-row surface (``FACTOR_SURFACE`` in
  backends/partition_factors.py: ``c_held`` / ``slot_of`` /
  ``range_slots``) may therefore only be touched inside the exchange
  layer itself; any other package module reading those attributes is
  reaching into rows it does not own, bypassing the ownership map, the
  fencing epochs, and the wire contract at once. Mirror of WC001's
  registry style: the guarded surface is a frozenset literal the pass
  parses out of the owning module, so rule and code cannot drift.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, qualname_index, symbol_at
from .wire import _frozenset_literal

RULE_DOCS = {
    "PT001": (
        "partition factor slice read outside the exchange layer",
        "only backends/partition_factors.py and serving/partition.py "
        "may touch the held-row factor surface (FACTOR_SURFACE) — "
        "anything else is reading factor rows it does not own, "
        "bypassing ownership, fencing, and the tile-exchange wire "
        "contract; go through the partition wire ops instead",
    ),
}

_SURFACE_FILE = "backends/partition_factors.py"
# the exchange layer: the slice builder and the partition worker that
# serves the wire ops over it
_ALLOWED = frozenset({
    "backends/partition_factors.py",
    "serving/partition.py",
})


class PartitionOwnershipPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        surface = None
        for m in modules:
            if m.root_kind == "package" and m.rel == _SURFACE_FILE:
                surface = _frozenset_literal(m.tree, "FACTOR_SURFACE")
                break
        if not surface:
            return findings  # no partition layer in this tree
        for m in modules:
            if m.root_kind != "package" or m.rel in _ALLOWED:
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
                        path=m.repo_rel, line=node.lineno, rule="PT001",
                        symbol=symbol_at(index, node.lineno),
                        message=(
                            f".{node.attr} read outside the partition "
                            "exchange layer — this is factor-row state "
                            "the module does not own; use the wire ops "
                            "(tile_pull / partial_* / set_colsum)"
                        ),
                    ))
        return findings
