"""Lock-discipline pass: guarded attributes stay guarded.

For every class that owns a ``threading.Lock``/``RLock`` field, the
pass computes the set of instance attributes *mutated* while that lock
is held (direct assignment, augmented assignment, subscript store/del,
or a mutating container method like ``append``/``pop``/``clear`` —
lexically inside a ``with self._lock:`` block, Conditions constructed
on the lock counting as the lock). Any read or write of a guarded
attribute on a path that provably does not hold the lock is a finding:

- **LD001** unlocked WRITE of a lock-guarded attribute (a real race:
  two writers, or a writer racing the locked readers), and
- **LD002** unlocked READ (torn/stale view of state the class itself
  says needs the lock).

"Provably does not hold it" is made precise by a small intra-class
dataflow: a private method whose every internal call site runs with the
lock held is itself treated as lock-held (fixpoint over the class's
call graph), so the common ``_helper_called_under_lock`` pattern is not
noise. ``__init__``/``__del__`` are exempt (construction is
single-threaded), and code inside nested functions/lambdas is treated
as NOT holding the enclosing lock — a closure runs later, on whatever
thread calls it, which is exactly how completion callbacks race.

Intended targets: the coalescer, the two-tier caches, the router's
pending table, the flight ring, the ANN confidence gate — everything
the serving tier touches from more than one thread.
"""

from __future__ import annotations

import ast
import dataclasses

from .astutil import call_name, self_attr
from .core import Finding, Module

_LOCK_CTORS = ("threading.Lock", "threading.RLock")
_MUTATORS = frozenset({
    "append", "appendleft", "add", "discard", "remove", "clear", "pop",
    "popitem", "popleft", "update", "setdefault", "move_to_end",
    "extend", "insert", "__setitem__",
})
_EXEMPT_METHODS = frozenset({"__init__", "__new__", "__del__"})

RULE_DOCS = {
    "LD001": (
        "unlocked write to a lock-guarded attribute",
        "the class writes this attribute under its lock elsewhere — an "
        "unlocked write races both the locked writers and every locked "
        "reader; take the lock (or baseline with a justification)",
    ),
    "LD002": (
        "unlocked read of a lock-guarded attribute",
        "the class mutates this attribute under its lock — an unlocked "
        "read can observe torn/stale state; take the lock (or baseline "
        "a deliberately racy read with a justification)",
    ),
}


@dataclasses.dataclass
class _ClassInfo:
    node: ast.ClassDef
    qual: str
    locks: set[str] = dataclasses.field(default_factory=set)
    # condition/alias attr -> underlying lock attr
    aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    # lock attr -> guarded instance attrs
    guarded: dict[str, set[str]] = dataclasses.field(default_factory=dict)
    methods: dict[str, ast.FunctionDef] = dataclasses.field(
        default_factory=dict
    )
    # method name -> set of locks held at EVERY internal call site
    held_for: dict[str, set[str]] = dataclasses.field(default_factory=dict)


def _classes(module: Module) -> list[_ClassInfo]:
    out = []

    def visit(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                info = _ClassInfo(node=child, qual=qual)
                for stmt in child.body:
                    if isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        info.methods[stmt.name] = stmt
                out.append(info)
                visit(child, qual)
            else:
                visit(child, prefix)

    visit(module.tree, "")
    return out


def _find_locks(info: _ClassInfo) -> None:
    for fn in info.methods.values():
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if len(node.targets) != 1:
                continue
            attr = self_attr(node.targets[0])
            if attr is None or not isinstance(node.value, ast.Call):
                continue
            cn = call_name(node.value)
            if cn in _LOCK_CTORS:
                info.locks.add(attr)
            elif cn == "threading.Condition" and node.value.args:
                base = self_attr(node.value.args[0])
                if base is not None:
                    info.aliases[attr] = base


def _with_locks(node: ast.With, info: _ClassInfo) -> set[str]:
    """Lock attrs this ``with`` acquires (conditions resolve to their
    lock)."""
    held: set[str] = set()
    for item in node.items:
        attr = self_attr(item.context_expr)
        if attr is None:
            continue
        if attr in info.locks:
            held.add(attr)
        elif attr in info.aliases:
            held.add(info.aliases[attr])
    return held


def _written_attrs(node: ast.AST) -> list[str]:
    """EVERY self-attribute a statement mutates (tuple targets included)."""
    out: list[str] = []
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        for t in targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for e in elts:
                attr = self_attr(e)
                if attr is not None:
                    out.append(attr)
                elif isinstance(e, ast.Subscript):
                    attr = self_attr(e.value)
                    if attr is not None:
                        out.append(attr)
    if isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                attr = self_attr(t.value)
                if attr is not None:
                    out.append(attr)
            attr = self_attr(t)
            if attr is not None:
                out.append(attr)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _MUTATORS:
            attr = self_attr(node.func.value)
            if attr is not None:
                out.append(attr)
    return out


def _collect_guarded(info: _ClassInfo) -> None:
    """Attrs mutated lexically under ``with self.<lock>``, per lock."""
    for lock in info.locks:
        info.guarded.setdefault(lock, set())

    def scan(node: ast.AST, held: frozenset[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                scan(child, frozenset())  # closures run unlocked
                continue
            child_held = held
            if isinstance(child, ast.With):
                child_held = held | _with_locks(child, info)
            if held:
                for attr in _written_attrs(child):
                    if attr in info.locks or attr in info.aliases:
                        continue
                    for lock in held:
                        info.guarded[lock].add(attr)
            scan(child, child_held)

    for fn in info.methods.values():
        scan(fn, frozenset())


def _held_fixpoint(info: _ClassInfo) -> None:
    """Private methods whose every internal call site holds lock L are
    themselves held-for-L."""
    # method -> list of lock-sets held at each internal call site
    callsites: dict[str, list[set[str]]] = {m: [] for m in info.methods}

    def scan(node: ast.AST, held: set[str], extra: set[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                # closures run later on whatever thread calls them: a
                # call site inside one holds NEITHER the lexical locks
                # NOR the enclosing method's held-for set
                scan(child, set(), set())
                continue
            child_held = held
            if isinstance(child, ast.With):
                child_held = held | _with_locks(child, info)
            if isinstance(child, ast.Call):
                m = None
                if (
                    isinstance(child.func, ast.Attribute)
                    and isinstance(child.func.value, ast.Name)
                    and child.func.value.id == "self"
                    and child.func.attr in info.methods
                ):
                    m = child.func.attr
                if m is not None:
                    callsites[m].append(set(child_held) | set(extra))
            scan(child, child_held, extra)

    info.held_for = {m: set() for m in info.methods}
    for _ in range(len(info.methods) + 1):
        for sites in callsites.values():
            sites.clear()
        for name, fn in info.methods.items():
            if name in _EXEMPT_METHODS:
                # construction is single-threaded: a call from __init__
                # needs no lock and must not veto a helper's heldness
                continue
            scan(fn, set(), info.held_for.get(name, set()))
        changed = False
        for name in info.methods:
            if not name.startswith("_") or name.startswith("__"):
                continue  # public methods are callable from anywhere
            sites = callsites[name]
            if not sites:
                continue
            new = set.intersection(*sites) if sites else set()
            if new != info.held_for[name]:
                info.held_for[name] = new
                changed = True
        if not changed:
            break


def _scan_method(fn, base_held, qual, info, all_guarded, module, findings):
    def scan(node: ast.AST, held: set[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan_unlocked(child, f"{qual}.<{child.name}>")
                continue
            if isinstance(child, ast.Lambda):
                scan_unlocked(child, qual)
                continue
            child_held = held
            if isinstance(child, ast.With):
                child_held = held | _with_locks(child, info)
            _check(child, held, qual)
            scan(child, child_held)

    def scan_unlocked(node: ast.AST, q: str) -> None:
        for child in ast.iter_child_nodes(node):
            _check(child, set(), q)
            scan_unlocked(child, q)

    reported: set[int] = set()

    def _check(node: ast.AST, held: set[str], q: str) -> None:
        for written in _written_attrs(node):
            if written not in all_guarded:
                continue
            locks = all_guarded[written]
            if not (locks & held):
                key = (id(node), written)
                if key not in reported:
                    reported.add(key)
                    findings.append(_mk(node, written, locks, q, True))
            # mark the attribute node of this statement as handled
            for sub in ast.walk(node):
                if self_attr(sub) == written:
                    reported.add(id(sub))
        if isinstance(node, ast.Attribute):
            attr = self_attr(node)
            if (
                attr in all_guarded
                and isinstance(node.ctx, ast.Load)
                and id(node) not in reported
            ):
                locks = all_guarded[attr]
                if not (locks & held):
                    reported.add(id(node))
                    findings.append(_mk(node, attr, locks, q, False))

    def _mk(node, attr, locks, q, write) -> Finding:
        lock_names = "/".join(sorted(locks))
        return Finding(
            path=module.repo_rel, line=node.lineno,
            rule="LD001" if write else "LD002", symbol=q,
            message=(
                f"{'write to' if write else 'read of'} self.{attr} "
                f"without holding self.{lock_names} (attribute is "
                f"mutated under that lock elsewhere in {info.qual})"
            ),
        )

    scan(fn, set(base_held))


class LockDisciplinePass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        for module in modules:
            if module.root_kind == "tests":
                continue  # test helpers race on purpose
            for info in _classes(module):
                _find_locks(info)
                if not info.locks:
                    continue
                _collect_guarded(info)
                _held_fixpoint(info)
                _report_safe(info, module, findings)
        return findings


def _report_safe(info, module, findings):
    all_guarded: dict[str, set[str]] = {}
    for lock, attrs in info.guarded.items():
        for a in attrs:
            all_guarded.setdefault(a, set()).add(lock)
    if not all_guarded:
        return
    for name, fn in info.methods.items():
        if name in _EXEMPT_METHODS:
            continue
        _scan_method(
            fn, info.held_for.get(name, set()),
            f"{info.qual}.{name}", info, all_guarded, module, findings,
        )
