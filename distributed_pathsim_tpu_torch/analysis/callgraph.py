"""Whole-repo call graph + the fact-propagation fixpoint engine.

This is the interprocedural backbone the semantic passes (interlocks.py,
wireschema.py) run on — and the hook of the two doorway passes: the
metapath-IR planner pass ("no chain evaluation outside the planner")
and the packed-layout boundary pass ("packed layouts must not leak past
the factor boundary") are both "facts propagated over this graph".

Design constraints, same as the rest of ``analysis/``:

- **One parse**: built from the already-loaded :class:`~.core.Module`
  list; no file is re-read.
- **Deterministic**: functions are indexed in source order of the
  sorted module walk; every iteration below runs over sorted keys, so
  witness chains and fixpoint results are byte-stable run to run.
- **Name-resolution honesty**: an edge exists only when the callee is
  *resolved* — ``self.m()`` to a method of the lexically enclosing
  class, bare/module-attribute calls through the module's import map,
  and ``x = ClassName(...); x.m()`` through a single-assignment local
  type map. Everything else (duck-typed attribute calls, dynamic
  dispatch) stays unresolved: the passes treat unresolved calls
  conservatively *per rule* (e.g. a blocking-primitive name match fires
  without resolution; lock facts never flow through an unresolved
  edge, so an unknown callee can hide a fact but never fabricate one).
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib

from .astutil import call_name, dotted
from .core import Module


@dataclasses.dataclass
class FuncInfo:
    """One function/method in the repo-wide index. ``fid`` is the
    stable identity findings and witness chains use:
    ``"<repo_rel>:<qualname>"``."""

    fid: str
    module: Module
    qual: str
    cls: str | None          # enclosing class qualname (None: free func)
    name: str                # bare name
    node: ast.FunctionDef | ast.AsyncFunctionDef

    @property
    def private(self) -> bool:
        """Callable only from inside the repo by convention: a leading
        underscore, not a dunder. Only private functions may inherit
        caller facts (anything public has unknown external callers)."""
        return self.name.startswith("_") and not self.name.startswith("__")

    @property
    def params(self) -> list[str]:
        a = self.node.args
        return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]


@dataclasses.dataclass
class CallSite:
    """One resolved or unresolved call inside ``caller``."""

    caller: str              # fid
    callee: str | None       # fid when resolved, else None
    node: ast.Call


class CallGraph:
    """The repo-wide function index + resolver. Construction walks
    every module once; :meth:`resolve` answers per-call-site questions
    for the passes (which also need the raw AST around the site, so
    they re-walk function bodies themselves with :meth:`resolve` in
    hand rather than consuming a pre-flattened edge list)."""

    def __init__(self, modules: list[Module]):
        self.modules = modules
        self.by_fid: dict[str, FuncInfo] = {}
        # (repo_rel, class_qual, method) -> fid
        self._methods: dict[tuple[str, str, str], str] = {}
        # (repo_rel, name) -> fid for module-level functions
        self._module_funcs: dict[tuple[str, str], str] = {}
        # (repo_rel, name) -> class qualname, for local classes
        self._classes: dict[tuple[str, str], str] = {}
        # per module repo_rel: imported name -> ("mod", target_repo_rel)
        #                                     | ("sym", target_rel, name)
        self._imports: dict[str, dict[str, tuple]] = {}
        self._by_repo_rel = {m.repo_rel: m for m in modules}
        self._lt_cache: dict[str, dict] = {}
        self._rel_index: dict[str, str] = {}  # package rel -> repo_rel
        for m in modules:
            self._rel_index.setdefault(m.rel, m.repo_rel)
        for m in modules:
            self._index_module(m)
        for m in modules:
            self._imports[m.repo_rel] = self._import_map(m)

    # -- indexing ----------------------------------------------------------

    def _index_module(self, m: Module) -> None:
        def visit(node: ast.AST, prefix: str, cls: str | None) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    qual = (
                        f"{prefix}.{child.name}" if prefix else child.name
                    )
                    self._classes[(m.repo_rel, child.name)] = qual
                    visit(child, qual, qual)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = (
                        f"{prefix}.{child.name}" if prefix else child.name
                    )
                    fid = f"{m.repo_rel}:{qual}"
                    info = FuncInfo(
                        fid=fid, module=m, qual=qual, cls=cls,
                        name=child.name, node=child,
                    )
                    self.by_fid[fid] = info
                    if cls is not None:
                        self._methods[(m.repo_rel, cls, child.name)] = fid
                    elif prefix == "":
                        self._module_funcs[(m.repo_rel, child.name)] = fid
                    # nested defs are not methods of the class
                    visit(child, qual, None)
                else:
                    visit(child, prefix, cls)

        visit(m.tree, "", None)

    def _module_dir_parts(self, m: Module) -> list[str]:
        return list(pathlib.PurePosixPath(m.rel).parts[:-1])

    def _candidate_rel(self, parts: list[str]) -> str | None:
        """A module path (as root-relative parts) -> repo_rel of the
        analyzed file implementing it, if any."""
        if not parts:
            return None
        for rel in ("/".join(parts) + ".py",
                    "/".join(parts) + "/__init__.py"):
            if rel in self._rel_index:
                return self._rel_index[rel]
        return None

    def _import_map(self, m: Module) -> dict[str, tuple]:
        """name -> resolution for this module's imports that land on an
        analyzed file. Absolute imports of the package are mapped by
        stripping the package name (the package root is a walk root)."""
        out: dict[str, tuple] = {}
        pkg_prefix = "distributed_pathsim_tpu_torch"
        for node in m.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    parts = alias.name.split(".")
                    if parts[0] == pkg_prefix:
                        parts = parts[1:]
                    rel = self._candidate_rel(parts)
                    if rel is not None:
                        out[alias.asname or parts[-1]] = ("mod", rel)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = self._module_dir_parts(m)
                    if node.level > 1:
                        base = base[: -(node.level - 1)] or []
                else:
                    base = []
                mod_parts = (node.module or "").split(".") if node.module \
                    else []
                if mod_parts and mod_parts[0] == pkg_prefix:
                    mod_parts = mod_parts[1:]
                target_parts = base + [p for p in mod_parts if p]
                for alias in node.names:
                    name = alias.asname or alias.name
                    # `from pkg import mod` (the name IS a module)
                    sub = self._candidate_rel(
                        target_parts + [alias.name]
                    )
                    if sub is not None:
                        out[name] = ("mod", sub)
                        continue
                    # `from pkg.mod import symbol`
                    rel = self._candidate_rel(target_parts)
                    if rel is not None:
                        out[name] = ("sym", rel, alias.name)
        return out

    # -- per-function local type map ---------------------------------------

    def local_types(self, fn: FuncInfo) -> dict[str, tuple[str, str]]:
        """Single-assignment ``x = ClassName(...)`` locals:
        name -> (repo_rel, class_qual). A name assigned twice (or to
        anything else) is dropped — no merging, no flow sensitivity.
        Cached per function (several passes ask repeatedly)."""
        hit = self._lt_cache.get(fn.fid)
        if hit is not None:
            return hit
        assigned: dict[str, tuple[str, str] | None] = {}
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not isinstance(t, ast.Name):
                continue
            hit = None
            if isinstance(node.value, ast.Call):
                cls = self.resolve_class(fn.module, node.value.func)
                if cls is not None:
                    hit = cls
            if t.id in assigned:
                assigned[t.id] = None  # reassigned: unknown
            else:
                assigned[t.id] = hit
        out = {k: v for k, v in assigned.items() if v is not None}
        self._lt_cache[fn.fid] = out
        return out

    def resolve_class(
        self, m: Module, node: ast.AST
    ) -> tuple[str, str] | None:
        """A Name/Attribute that names a class we indexed."""
        if isinstance(node, ast.Name):
            key = (m.repo_rel, node.id)
            if key in self._classes:
                return (m.repo_rel, self._classes[key])
            imp = self._imports.get(m.repo_rel, {}).get(node.id)
            if imp is not None and imp[0] == "sym":
                key = (imp[1], imp[2])
                if key in self._classes:
                    return (imp[1], self._classes[key])
        elif isinstance(node, ast.Attribute) and isinstance(
            node.value, ast.Name
        ):
            imp = self._imports.get(m.repo_rel, {}).get(node.value.id)
            if imp is not None and imp[0] == "mod":
                key = (imp[1], node.attr)
                if key in self._classes:
                    return (imp[1], self._classes[key])
        return None

    # -- call resolution ---------------------------------------------------

    def resolve(
        self, fn: FuncInfo, call: ast.Call,
        local_types: dict[str, tuple[str, str]] | None = None,
    ) -> str | None:
        """fid of the callee, or None. ``local_types`` is the caller's
        :meth:`local_types` map (passed in so a body walk computes it
        once)."""
        m = fn.module
        func = call.func
        # self.method()
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
        ):
            base, attr = func.value.id, func.attr
            if base == "self" and fn.cls is not None:
                fid = self._methods.get((m.repo_rel, fn.cls, attr))
                if fid is not None:
                    return fid
            if local_types and base in local_types:
                rel, cls = local_types[base]
                fid = self._methods.get((rel, cls, attr))
                if fid is not None:
                    return fid
            imp = self._imports.get(m.repo_rel, {}).get(base)
            if imp is not None and imp[0] == "mod":
                return self._module_funcs.get((imp[1], attr))
            return None
        if isinstance(func, ast.Name):
            fid = self._module_funcs.get((m.repo_rel, func.id))
            if fid is not None:
                return fid
            imp = self._imports.get(m.repo_rel, {}).get(func.id)
            if imp is not None and imp[0] == "sym":
                return self._module_funcs.get((imp[1], imp[2]))
        return None

    def call_sites(self) -> list[CallSite]:
        """Every call in every function, in deterministic order.
        Memoized on the instance: the walk+resolve is a real fraction
        of the tier-1 lint budget and the graph is immutable after
        construction, so every interprocedural pass sharing this graph
        shares one walk."""
        cached = getattr(self, "_call_sites_cache", None)
        if cached is not None:
            return cached
        out: list[CallSite] = []
        for fid in sorted(self.by_fid):
            fn = self.by_fid[fid]
            lt = self.local_types(fn)
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    out.append(CallSite(
                        caller=fid,
                        callee=self.resolve(fn, node, lt),
                        node=node,
                    ))
        self._call_sites_cache = out
        return out

    def functions_named(
        self, name: str, rel_prefix: str = "",
        with_param: str | None = None,
    ) -> list[FuncInfo]:
        """Fallback resolution for dynamic dispatch (``getattr(service,
        op)``-style trampolines): every indexed function with this bare
        name, optionally restricted to a tree and to functions taking a
        parameter of a given name. Sorted by fid."""
        out = []
        for fid in sorted(self.by_fid):
            fn = self.by_fid[fid]
            if fn.name != name:
                continue
            if rel_prefix and not fn.module.rel.startswith(rel_prefix):
                continue
            if with_param is not None and with_param not in fn.params:
                continue
            out.append(fn)
        return out


# -- the generic fixpoint engine ---------------------------------------------


def propagate_reachability(
    graph: CallGraph,
    seeds: dict[str, str],
    edges: dict[str, set[str]] | None = None,
) -> dict[str, list[str]]:
    """The "facts over the call graph to fixpoint" primitive: given
    seed functions (fid -> human-readable witness for WHY the fact
    holds there, e.g. "queue.get()"), compute every function from which
    a seed is reachable through resolved call edges. Returns fid ->
    witness chain ``[fid, fid, ..., seed_witness]`` (shortest-first by
    construction: BFS over the reverse graph; ties broken by sorted
    order, so chains are deterministic).

    ``edges`` overrides the graph's own resolved edges when a pass has
    already computed them (caller fid -> set of callee fids)."""
    if edges is None:
        edges = {}
        for site in graph.call_sites():
            if site.callee is not None:
                edges.setdefault(site.caller, set()).add(site.callee)
    reverse: dict[str, set[str]] = {}
    for caller in sorted(edges):
        for callee in sorted(edges[caller]):
            reverse.setdefault(callee, set()).add(caller)
    chains: dict[str, list[str]] = {
        fid: [witness] for fid, witness in sorted(seeds.items())
    }
    frontier = sorted(seeds)
    while frontier:
        next_frontier: list[str] = []
        for fid in frontier:
            for caller in sorted(reverse.get(fid, ())):
                if caller in chains:
                    continue
                chains[caller] = [fid] + chains[fid]
                next_frontier.append(caller)
        frontier = next_frontier
    return chains


def strongly_connected(edges: dict[str, set[str]]) -> list[list[str]]:
    """Tarjan SCCs over a token graph (used by the lock-order pass).
    Deterministic: nodes visited in sorted order, components returned
    sorted by their smallest member. Only components that can actually
    cycle (size > 1, or a self-edge) are returned."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]
    nodes = sorted(set(edges) | {v for vs in edges.values() for v in vs})

    def strong(v: str) -> None:
        # iterative Tarjan: recursion depth is unbounded on long chains
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or node in edges.get(node, ()):
                    out.append(sorted(comp))

    for v in nodes:
        if v not in index:
            strong(v)
    return sorted(out, key=lambda c: c[0])


def dotted_tail(node: ast.AST) -> str | None:
    """Like :func:`~.astutil.dotted` but tolerant of non-Name chain
    heads: returns the trailing attribute path (``"transport.send"``
    for ``self.workers[w].transport.send``), which is what suffix-based
    primitive matching wants."""
    full = dotted(node)
    if full is not None:
        return full
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    return ".".join(reversed(parts)) if parts else None


# One package-view CallGraph per analysis run: the interprocedural
# passes over `root_kind == "package"` (wire schema WC101+, MP001,
# CF001) all consume the IDENTICAL graph, and building it (plus the
# call-site walk) once per pass was a real fraction of the tier-1
# lint time budget. Keyed by the module objects' identities — safe
# because the cached graph holds the modules strongly, so their ids
# cannot be reused while the entry is alive; a new run parses new
# Module objects and misses.
_PKG_GRAPH_CACHE: tuple[tuple[int, ...], CallGraph] | None = None


def shared_package_graph(modules: list[Module]) -> CallGraph:
    global _PKG_GRAPH_CACHE
    pkg = [m for m in modules if m.root_kind == "package"]
    key = tuple(id(m) for m in pkg)
    if _PKG_GRAPH_CACHE is not None and _PKG_GRAPH_CACHE[0] == key:
        return _PKG_GRAPH_CACHE[1]
    graph = CallGraph(pkg)
    _PKG_GRAPH_CACHE = (key, graph)
    return graph


__all__ = [
    "CallGraph",
    "CallSite",
    "FuncInfo",
    "call_name",
    "dotted_tail",
    "propagate_reachability",
    "strongly_connected",
]
