"""Compressed-layout pass: packed factors stay behind the factory.

- **CF001 packed-layout-reached-outside-the-factory**: the compressed
  factor layouts (ops/packed.py, DESIGN.md §29) store column ids in a
  hub-first PERMUTED coordinate system, weights in narrow chunk-local
  dtypes, and rows in a derived hub-first layout order. Those internals
  are only meaningful through the sanctioned factory surface
  (``SANCTIONED_FACTORY``), whose accessors invert the permutations and
  widen the dtypes at every return — a module that reaches the
  constructors/accessors around the factory, or reads the raw layout
  attributes (``PACKED_SURFACE``), is consuming permuted-space ids as
  if they were global columns: exactly the silent bit-parity corruption
  the boundary exists to prevent. This is the packed-layout
  interprocedural hook (DESIGN.md §27): seed every function the
  packed module defines OUTSIDE the factory set, cut the call graph at
  the factory doorway (edges into ``SANCTIONED_FACTORY`` functions of
  ops/packed.py are removed — going through the doorway IS the
  sanctioned path), run ``callgraph.propagate_reachability``, and flag
  every package function outside the factor modules from which a seed
  is still reachable; the PT001-style attribute scan covers the
  data-read half of the surface. Both registries are frozenset literals
  parsed out of ops/packed.py (the WC001 pattern), so the rule and the
  code cannot drift.
"""

from __future__ import annotations

import ast

from .callgraph import propagate_reachability, shared_package_graph
from .core import Finding, Module, qualname_index, symbol_at
from .wire import _frozenset_literal

RULE_DOCS = {
    "CF001": (
        "packed factor layout reached outside the sanctioned factory",
        "compressed factor internals (ops/packed.py) speak a permuted, "
        "narrow-dtype coordinate system; only the SANCTIONED_FACTORY "
        "surface inverts it. Reaching the constructors/accessors "
        "around the factory — or reading PACKED_SURFACE attributes — "
        "consumes permuted ids as global ones and silently breaks the "
        "bit-parity contract; go through ops/packed.py "
        "(make_factor / as_coo / row_slice / patch_factor / "
        "factor_bytes …) instead",
    ),
}

_PACKED = "ops/packed.py"
# The factor modules: packed itself, the tiled half-chain host that
# feeds device scatters (ops/sparse.py), and the partition slice
# builder — their internals may compose the layouts freely; the
# boundary is the module surface (same shape as PT001/MP001).
_ALLOWED = frozenset({
    "ops/packed.py",
    "ops/sparse.py",
    "backends/partition_factors.py",
})


class CompressedLayoutPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        pkg = [m for m in modules if m.root_kind == "package"]
        surface = factory = None
        for m in pkg:
            if m.rel == _PACKED:
                surface = _frozenset_literal(m.tree, "PACKED_SURFACE")
                factory = _frozenset_literal(m.tree, "SANCTIONED_FACTORY")
                break
        if not surface or not factory:
            return []  # no packed layer in this tree (fixture corpora)
        findings: list[Finding] = []
        # (a) PT001-style attribute guard: raw layout state read
        # outside the factor modules.
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
                        path=m.repo_rel, line=node.lineno, rule="CF001",
                        symbol=symbol_at(index, node.lineno),
                        message=(
                            f".{node.attr} read outside the factor "
                            "modules — raw packed-layout state in a "
                            "permuted coordinate system; go through "
                            "the ops/packed.py factory surface"
                        ),
                    ))
        # (b) MP001-style reachability: seeds are every function the
        # packed module defines outside the factory set (private
        # encoders/decoders, PackedFactor methods); the doorway cut
        # removes edges into factory functions BEFORE propagation, so
        # "reaches a seed" means "reaches it around the factory".
        graph = shared_package_graph(modules)
        seeds: dict[str, str] = {}
        for fid in sorted(graph.by_fid):
            fn = graph.by_fid[fid]
            if fn.module.rel != _PACKED:
                continue
            if fn.qual.split(".", 1)[0] in factory:
                continue
            seeds[fid] = f"packed.{fn.qual}()"
        if not seeds:
            return findings
        edges: dict[str, set[str]] = {}
        for site in graph.call_sites():
            if site.callee is None:
                continue
            callee = graph.by_fid[site.callee]
            if (
                callee.module.rel == _PACKED
                and callee.qual.split(".", 1)[0] in factory
            ):
                continue
            edges.setdefault(site.caller, set()).add(site.callee)
        chains = propagate_reachability(graph, seeds, edges=edges)
        for fid in sorted(chains):
            fn = graph.by_fid.get(fid)
            if fn is None or fn.module.rel in _ALLOWED:
                continue
            witness = " -> ".join(chains[fid])
            findings.append(Finding(
                path=fn.module.repo_rel,
                line=fn.node.lineno,
                rule="CF001",
                symbol=fn.qual,
                message=(
                    f"reaches a packed-layout constructor/accessor "
                    f"without going through the sanctioned factory "
                    f"({witness}); use ops/packed.py (make_factor / "
                    "as_coo / row_slice / patch_factor) instead"
                ),
            ))
        return findings
