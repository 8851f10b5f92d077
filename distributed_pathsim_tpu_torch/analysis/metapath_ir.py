"""Metapath-IR pass: no chain evaluation outside the planner.

- **MP001 chain-evaluation-outside-the-planner**: the metapath-IR
  refactor (DESIGN.md §28) made the adjacency chain *data*: the only
  sanctioned way to evaluate it is through ``ops/planner.py``, whose
  plans carry the DP association order, the cost estimates, and the
  sub-chain memoization hooks. A module that calls a chain-fold
  primitive directly gets none of that — it silently reverts to the
  hardcoded left-to-right fold the refactor retired, bypasses the
  workload memo, and its results stop being auditable through the
  plan dump. This is exactly the reachability query the
  interprocedural engine was built for (DESIGN.md §27): seed
  every chain-evaluation primitive (``chain_product`` /
  ``half_product`` / ``rowsums_general`` in ops/chain.py, the COO
  ``fold_half_chain`` in ops/sparse.py), cut the call graph at the
  planner doorway (edges INTO ops/planner.py functions are removed —
  going through the doorway is the sanctioned path), run
  ``callgraph.propagate_reachability``, and flag every package
  function outside the primitive-owning modules from which a seed is
  still reachable. The finding message carries the witness chain, so
  the report says *how* the module reaches the primitive.

Deliberately NOT seeded: the half-factor *scoring* primitives
(``commuting_matrix_from_half``, ``rowsums_from_half``,
``pairwise_row_from_half``, the tile/ring GEMM kernels) — those
consume an already-folded factor C, they do not evaluate the chain;
and ``coo_matmul`` — the delta algebra's product rule uses it for
O(Δ) patches, which is incremental maintenance, not evaluation.
"""

from __future__ import annotations

from .callgraph import propagate_reachability, shared_package_graph
from .core import Finding, Module

RULE_DOCS = {
    "MP001": (
        "chain evaluation outside the planner",
        "the metapath chain is data: every evaluation must go through "
        "ops/planner.py (plan_metapath + fold_half / fold_general / "
        "fold_blocks / execute_dense / rowsums_fold), which owns the "
        "DP association order, the cost audit, and the sub-chain "
        "memo. Direct calls to the chain-fold primitives silently "
        "revert to the hardcoded left-to-right fold the metapath-IR "
        "refactor retired",
    ),
}

# (package-relative module, function qualname) -> human witness. These
# are the chain-evaluation primitives; reaching one without passing
# through the planner doorway is the violation.
_SEEDS: dict[tuple[str, str], str] = {
    ("ops/chain.py", "chain_product"): "chain.chain_product()",
    ("ops/chain.py", "half_product"): "chain.half_product()",
    ("ops/chain.py", "rowsums_general"): "chain.rowsums_general()",
    ("ops/sparse.py", "fold_half_chain"): "sparse.fold_half_chain()",
}

# The planner itself plus the primitive-owning modules (their
# internals may compose each other freely; the boundary is the module
# surface, same shape as PT001's exchange-layer allowance).
_PLANNER = "ops/planner.py"
_ALLOWED = frozenset({_PLANNER, "ops/chain.py", "ops/sparse.py"})


class MetapathIRPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        graph = shared_package_graph(modules)
        seeds: dict[str, str] = {}
        for fid in sorted(graph.by_fid):
            fn = graph.by_fid[fid]
            key = (fn.module.rel, fn.qual)
            if key in _SEEDS:
                seeds[fid] = _SEEDS[key]
        if not seeds:
            return []  # no chain layer in this tree (fixture corpora)
        # The doorway cut: edges into planner-defined functions are
        # removed BEFORE propagation, so "reaches a seed" means
        # "reaches it without going through the planner" — the exact
        # sanctioned/unsanctioned distinction the rule states.
        edges: dict[str, set[str]] = {}
        for site in graph.call_sites():
            if site.callee is None:
                continue
            callee = graph.by_fid[site.callee]
            if callee.module.rel == _PLANNER:
                continue
            edges.setdefault(site.caller, set()).add(site.callee)
        chains = propagate_reachability(graph, seeds, edges=edges)
        findings: list[Finding] = []
        for fid in sorted(chains):
            fn = graph.by_fid.get(fid)
            if fn is None or fn.module.rel in _ALLOWED:
                continue
            witness = " -> ".join(chains[fid])
            findings.append(Finding(
                path=fn.module.repo_rel,
                line=fn.node.lineno,
                rule="MP001",
                symbol=fn.qual,
                message=(
                    f"reaches a chain-evaluation primitive without "
                    f"going through the planner ({witness}); use "
                    "ops/planner.py (fold_half / fold_general / "
                    "execute_dense / rowsums_fold) instead"
                ),
            ))
        return findings
