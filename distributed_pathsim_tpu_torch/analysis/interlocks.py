"""Interprocedural lock-order / blocking-under-lock pass (LD100s).

The :mod:`locks` pass answers "is this attribute touched without
the lock" *inside one class*. The partition tier (DESIGN.md §26) added
the hazards that analysis cannot see: locks held across cross-process
protocol round-trips, and lock acquisition orders spread over many
classes. This pass generalizes the held-lock story to the whole repo,
on the :mod:`callgraph` engine:

- **Held-locks-at-entry**: a *private* function whose every resolved
  call site runs with lock L held is analyzed as entering with L held
  (the interprocedural version of locks.py's intra-class fixpoint).
  Public functions enter with nothing — their external callers are
  unknown, and an unknown caller must never fabricate a fact.
- **LD101 lock-order cycle**: every acquisition of lock B while lock A
  is held is an edge A→B in the global lock-acquisition-order graph;
  a cycle is a potential deadlock (two threads walking the cycle from
  different entry points block each other forever). Re-acquiring an
  ``RLock`` you already hold is reentrant and ignored; a self-edge on
  a plain ``Lock`` is reported — that one is a guaranteed single-thread
  deadlock.
- **LD102 blocking call under a lock**: a blocking primitive
  (``queue.get()``, ``.wait()``, ``.result()``, ``.join()``,
  ``time.sleep``, ``subprocess`` waits, socket reads) — or a call that
  *transitively reaches* one — executed while a lock is held. Waiting
  on a Condition you hold is THE condition-variable pattern (the wait
  releases it) and is exempt for that lock only.
- **LD103 transport round-trip under a lock**: a worker-transport send
  (or a call reaching one — the ``_broadcast``/``tile_pull``/
  ``partial_topk`` helpers that await a protocol reply) while a lock
  is held. A pipe send can block on a stalled peer, and the reply
  arrives on a reader thread that may need the very lock the sender
  holds: this is how single-process discipline becomes a distributed
  deadlock. LD103 subsumes LD102 at the same site (one finding per
  site, the sharper rule wins).

Witness chains name the path (``f -> g -> queue.get()``) so a finding
at an outer call site is actionable without re-deriving the analysis.
"""

from __future__ import annotations

import ast

from .callgraph import (
    CallGraph,
    FuncInfo,
    dotted_tail,
    propagate_reachability,
    strongly_connected,
)
from .astutil import call_name
from .core import Finding, Module

RULE_DOCS = {
    "LD101": (
        "lock-order cycle (potential deadlock)",
        "two code paths acquire these locks in opposite orders — two "
        "threads entering from different ends block each other forever; "
        "pick one global order (or baseline a provably single-threaded "
        "pairing with a justification)",
    ),
    "LD102": (
        "blocking call while holding a lock",
        "the lock is held across a wait (queue.get/.wait/.result/"
        ".join/sleep/subprocess) — every other thread needing it stalls "
        "for the full wait, and if the waited-on work needs the lock "
        "too, forever; move the wait outside the critical section",
    ),
    "LD103": (
        "transport send / protocol round-trip while holding a lock",
        "a worker-transport send can block on a stalled peer, and its "
        "reply is delivered by a reader thread that may need this very "
        "lock — single-process lock discipline becomes a distributed "
        "deadlock; send after releasing (the repo's routers do exactly "
        "this everywhere else)",
    ),
}

_LOCK_CTORS = ("threading.Lock", "threading.RLock")
_REENTRANT_CTORS = ("threading.RLock",)
_EXEMPT_METHODS = frozenset({"__init__", "__new__", "__del__"})

# dotted-callee names that block outright
_BLOCKING_NAMES = frozenset({
    "time.sleep", "subprocess.run", "subprocess.check_call",
    "subprocess.check_output", "subprocess.call", "select.select",
    "os.read", "input",
})
# attribute methods that block when called with no positional payload
# (queue.get() blocks; dict.get(k) doesn't — the payload IS the tell;
# same for Thread.join() vs "sep".join(parts))
_BLOCKING_ZERO_ARG_ATTRS = frozenset({"get", "join"})
# attribute methods that block regardless of arguments
_BLOCKING_ATTRS = frozenset({
    "wait", "result", "communicate", "recv", "recv_into", "accept",
    "acquire_timeout",
})


class _Lock:
    __slots__ = ("token", "reentrant")

    def __init__(self, token: str, reentrant: bool):
        self.token = token
        self.reentrant = reentrant


class _ModuleLocks:
    """Lock identities visible in one module: per-class self-attr locks
    (+ Condition aliases) and module-level locks."""

    def __init__(self, module: Module):
        self.module = module
        # class qual -> {attr: _Lock}
        self.class_locks: dict[str, dict[str, _Lock]] = {}
        # class qual -> {alias attr: underlying attr}
        self.class_aliases: dict[str, dict[str, str]] = {}
        # module-level name -> _Lock
        self.globals: dict[str, _Lock] = {}
        self._scan()

    def _scan(self) -> None:
        m = self.module
        for node in m.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
            ):
                cn = call_name(node.value)
                if cn in _LOCK_CTORS or (
                    cn == "threading.Condition" and not node.value.args
                ):
                    name = node.targets[0].id
                    self.globals[name] = _Lock(
                        token=f"{m.repo_rel}:{name}",
                        reentrant=cn in _REENTRANT_CTORS,
                    )

        def classes(node: ast.AST, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    qual = (
                        f"{prefix}.{child.name}" if prefix else child.name
                    )
                    yield qual, child
                    yield from classes(child, qual)
                else:
                    yield from classes(child, prefix)

        for qual, cls in classes(m.tree, ""):
            locks: dict[str, _Lock] = {}
            aliases: dict[str, str] = {}
            for node in ast.walk(cls):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)
                ):
                    continue
                t = node.targets[0]
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                cn = call_name(node.value)
                if cn in _LOCK_CTORS:
                    locks[t.attr] = _Lock(
                        token=f"{m.repo_rel}:{qual}.{t.attr}",
                        reentrant=cn in _REENTRANT_CTORS,
                    )
                elif cn == "threading.Condition":
                    if node.value.args:
                        arg = node.value.args[0]
                        if (
                            isinstance(arg, ast.Attribute)
                            and isinstance(arg.value, ast.Name)
                            and arg.value.id == "self"
                        ):
                            aliases[t.attr] = arg.attr
                    else:
                        # a bare Condition owns its own lock
                        locks[t.attr] = _Lock(
                            token=f"{m.repo_rel}:{qual}.{t.attr}",
                            reentrant=True,
                        )
            if locks or aliases:
                self.class_locks[qual] = locks
                self.class_aliases[qual] = aliases


def _blocking_primitive(call: ast.Call) -> str | None:
    """Witness string when this call is a known blocking primitive."""
    name = call_name(call)
    if name in _BLOCKING_NAMES:
        return f"{name}()"
    if isinstance(call.func, ast.Name) and call.func.id == "input":
        return "input()"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _BLOCKING_ATTRS:
            return f".{attr}()"
        if attr in _BLOCKING_ZERO_ARG_ATTRS and not call.args:
            return f".{attr}()"
    return None


def _transport_send(call: ast.Call) -> bool:
    tail = dotted_tail(call.func)
    return tail is not None and (
        tail.endswith("transport.send") or tail == "transport.send"
    )


class _FnFacts:
    """What one walk of a function body produced."""

    __slots__ = ("blocking", "sends", "acquires", "calls")

    def __init__(self):
        # (node, frozenset[token], witness, receiver_token|None)
        self.blocking: list[tuple] = []
        # (node, frozenset[token])
        self.sends: list[tuple] = []
        # (node, acquired _Lock, frozenset[token held])
        self.acquires: list[tuple] = []
        # (node, callee fid, frozenset[token])
        self.calls: list[tuple] = []


class InterLockPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        analyzed = [m for m in modules if m.root_kind != "tests"]
        if not analyzed:
            return []
        graph = CallGraph(analyzed)
        locks_by_mod = {m.repo_rel: _ModuleLocks(m) for m in analyzed}
        lock_kind: dict[str, bool] = {}  # token -> reentrant
        for ml in locks_by_mod.values():
            for lk in ml.globals.values():
                lock_kind[lk.token] = lk.reentrant
            for cl in ml.class_locks.values():
                for lk in cl.values():
                    lock_kind[lk.token] = lk.reentrant

        # ONE walk per function, recording facts with the LEXICAL held
        # sets; the entry-held fixpoint then runs over the recorded
        # call sites alone (effective held at any fact = recorded ∪
        # entry[function]) — same result as re-walking to fixpoint,
        # without the O(iterations × functions) re-walks.
        facts: dict[str, _FnFacts] = {
            fid: self._walk(graph.by_fid[fid], graph, locks_by_mod,
                            frozenset())
            for fid in sorted(graph.by_fid)
        }
        sites: dict[str, list[tuple[str, frozenset[str]]]] = {}
        for fid in sorted(facts):
            for _node, callee, held in facts[fid].calls:
                sites.setdefault(callee, []).append((fid, held))
        entry: dict[str, frozenset[str]] = {
            fid: frozenset() for fid in graph.by_fid
        }
        for _ in range(len(graph.by_fid) + 1):
            changed = False
            for fid in sorted(graph.by_fid):
                fn = graph.by_fid[fid]
                if not fn.private:
                    continue
                got = sites.get(fid)
                if not got:
                    continue
                new = frozenset.intersection(*[
                    held | entry[caller] for caller, held in got
                ])
                if new != entry[fid]:
                    entry[fid] = new
                    changed = True
            if not changed:
                break

        findings: list[Finding] = []
        self._report_order_cycles(graph, facts, entry, lock_kind,
                                  findings)
        self._report_blocking(graph, facts, entry, findings)
        return findings

    # -- body walk ---------------------------------------------------------

    def _walk(
        self, fn: FuncInfo, graph: CallGraph,
        locks_by_mod: dict[str, _ModuleLocks],
        entry_held: frozenset[str],
    ) -> _FnFacts:
        ml = locks_by_mod[fn.module.repo_rel]
        cls_locks = ml.class_locks.get(fn.cls or "", {})
        cls_aliases = ml.class_aliases.get(fn.cls or "", {})
        local_types = graph.local_types(fn)
        out = _FnFacts()
        exempt = fn.name in _EXEMPT_METHODS

        def lock_of(expr: ast.AST) -> _Lock | None:
            """The lock a with-item / receiver names, if any."""
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
            ):
                attr = expr.attr
                if attr in cls_aliases:
                    attr = cls_aliases[attr]
                return cls_locks.get(attr)
            if isinstance(expr, ast.Name):
                return ml.globals.get(expr.id)
            return None

        def scan(node: ast.AST, held: frozenset[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    # a closure runs later, on whatever thread calls it
                    # — its body is NOT this function's body. Nested
                    # defs are indexed and walked as functions in their
                    # own right; absorbing their facts here would make
                    # "defines a blocking callback" read as "blocks"
                    continue
                child_held = held
                if isinstance(child, ast.With):
                    # items acquire left-to-right: item N+1 is taken
                    # with item N already held, so `with a, b:` must
                    # produce the a->b order edge exactly like the
                    # nested-with spelling
                    for item in child.items:
                        lk = lock_of(item.context_expr)
                        if lk is None:
                            continue
                        if not exempt:
                            out.acquires.append((child, lk, child_held))
                        child_held = child_held | {lk.token}
                if isinstance(child, ast.Call) and not exempt:
                    self._classify_call(
                        child, held, fn, graph, local_types,
                        lock_of, out,
                    )
                scan(child, child_held)

        scan(fn.node, entry_held)
        return out

    def _classify_call(
        self, call: ast.Call, held, fn, graph, local_types, lock_of, out,
    ) -> None:
        # explicit .acquire() is an acquisition too (order edges); the
        # release-discipline half is the EX001 rule's business
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"
        ):
            lk = lock_of(call.func.value)
            if lk is not None:
                out.acquires.append((call, lk, held))
                return
        if _transport_send(call):
            out.sends.append((call, held))
            return
        witness = _blocking_primitive(call)
        if witness is not None:
            receiver = None
            if isinstance(call.func, ast.Attribute):
                lk = lock_of(call.func.value)
                if lk is not None:
                    receiver = lk.token
            out.blocking.append((call, held, witness, receiver))
            return
        callee = graph.resolve(fn, call, local_types)
        if callee is not None:
            out.calls.append((call, callee, held))

    # -- reporting ---------------------------------------------------------

    def _report_order_cycles(self, graph, facts, entry, lock_kind,
                             findings):
        edges: dict[str, set[str]] = {}
        sites: dict[tuple[str, str], tuple] = {}  # edge -> (fid, node)
        for fid in sorted(facts):
            for node, lk, held in facts[fid].acquires:
                for h in sorted(held | entry[fid]):
                    if h == lk.token:
                        if lock_kind.get(lk.token, True):
                            continue  # RLock re-entry is fine
                    edges.setdefault(h, set()).add(lk.token)
                    sites.setdefault((h, lk.token), (fid, node))
        for comp in strongly_connected(edges):
            in_cycle = [
                (a, b) for (a, b) in sorted(sites)
                if a in comp and b in comp
            ]
            if not in_cycle:
                continue
            where = sites[in_cycle[0]]
            fn = graph.by_fid[where[0]]
            order = " -> ".join(comp + [comp[0]]) if len(comp) > 1 \
                else f"{comp[0]} -> {comp[0]}"
            at = "; ".join(
                f"{a.split(':', 1)[1]} then {b.split(':', 1)[1]} in "
                f"{sites[(a, b)][0].split(':', 1)[1]}"
                for a, b in in_cycle
            )
            findings.append(Finding(
                path=fn.module.repo_rel, line=where[1].lineno,
                rule="LD101", symbol=fn.qual,
                message=(
                    f"lock-order cycle {order} (acquisitions: {at}) — "
                    "threads entering from different ends deadlock"
                ),
            ))

    def _report_blocking(self, graph, facts, entry, findings):
        # fixpoint facts: which functions transitively block / send
        call_edges: dict[str, set[str]] = {}
        for fid in sorted(facts):
            for _node, callee, _held in facts[fid].calls:
                call_edges.setdefault(fid, set()).add(callee)
        block_seeds = {
            fid: f[0][2]
            for fid, ff in sorted(facts.items())
            if (f := ff.blocking)
        }
        send_seeds = {
            fid: "transport.send"
            for fid, ff in sorted(facts.items()) if ff.sends
        }
        may_block = propagate_reachability(
            graph, block_seeds, edges=call_edges
        )
        may_send = propagate_reachability(
            graph, send_seeds, edges=call_edges
        )

        def chain(fids: list[str]) -> str:
            return " -> ".join(
                f.split(":", 1)[1] if ":" in f else f for f in fids
            )

        for fid in sorted(facts):
            fn = graph.by_fid[fid]
            ff = facts[fid]
            at_entry = entry[fid]
            reported: set[int] = set()

            def emit(node, rule, msg):
                if id(node) in reported:
                    return
                reported.add(id(node))
                findings.append(Finding(
                    path=fn.module.repo_rel, line=node.lineno,
                    rule=rule, symbol=fn.qual, message=msg,
                ))

            for node, held in ff.sends:
                held = held | at_entry
                if held:
                    emit(node, "LD103", (
                        "transport send while holding "
                        f"{_fmt_locks(held)} — the reply arrives on a "
                        "reader thread that may need this lock"
                    ))
            for node, held, witness, receiver in ff.blocking:
                effective = set(held | at_entry)
                if receiver is not None:
                    effective.discard(receiver)  # cv.wait releases it
                if effective:
                    emit(node, "LD102", (
                        f"blocking {witness} while holding "
                        f"{_fmt_locks(effective)}"
                    ))
            for node, callee, held in ff.calls:
                held = held | at_entry
                if not held:
                    continue
                if callee in may_send:
                    emit(node, "LD103", (
                        "call reaches a transport round-trip ("
                        f"{chain([callee] + may_send[callee][:-1])} -> "
                        f"{may_send[callee][-1]}) while holding "
                        f"{_fmt_locks(held)}"
                    ))
                elif callee in may_block:
                    emit(node, "LD102", (
                        "call reaches a blocking "
                        f"{may_block[callee][-1]} (via "
                        f"{chain([callee] + may_block[callee][:-1])}) "
                        f"while holding {_fmt_locks(held)}"
                    ))


def _fmt_locks(tokens) -> str:
    return "/".join(
        t.split(":", 1)[1] if ":" in t else t for t in sorted(tokens)
    )
