"""Exception-safety / exactly-once resource passes (EX001s).

The partition tier's pending-table/fencing state machine (DESIGN.md
§26) must resolve every acquisition exactly once — including on
exception edges, where "we'll clean it up two statements later" is a
leak. Three rules, all CFG-lite (lexical regions + try/finally
awareness, no path enumeration):

- **EX001 bare lock acquire**: ``lock.acquire()`` whose matching
  ``release()`` is not guaranteed on exception exits — not inside a
  ``try`` whose ``finally`` releases it. ``with lock:`` is always the
  answer; an explicit acquire is only tolerated release-in-finally.
- **EX002 leaked resource handle**: a locally-bound ``open(...)`` /
  ``subprocess.Popen(...)`` / ``os.fdopen(...)`` that is neither
  ``with``-managed nor closed in a ``finally`` — on the exception
  path the fd/child outlives the function. Handles that *escape*
  (stored on ``self``, returned, passed to another call) transfer
  ownership and are exempt: their lifetime is someone else's contract.
- **EX003 registration not exception-safe**: a function that both
  inserts into and removes from the same ``self.<table>`` (the
  pending-table / collector pattern) where a statement that can raise
  sits between the insert and a removal that is not in a covering
  ``finally`` — the exception skips the removal and the entry leaks
  forever (a pending entry that never resolves IS a hung client).
  Long-lived registrations resolved by a *different* function
  (callback-resolved pending tables) are out of scope by construction:
  the rule only fires when the same function owns both ends.
"""

from __future__ import annotations

import ast

from .astutil import call_name, own_nodes as _own_nodes, walk_functions
from .core import Finding, Module, qualname_index, symbol_at

RULE_DOCS = {
    "EX001": (
        "lock.acquire() without a guaranteed release",
        "an exception between acquire and release leaves the lock held "
        "forever — every later taker deadlocks; use `with lock:` (or "
        "release in a `finally`)",
    ),
    "EX002": (
        "resource handle leaked on exception paths",
        "a locally-opened file/process that isn't with-managed or "
        "closed in a finally outlives the function when an exception "
        "fires — fds and zombie children accumulate; use `with` (or "
        "close/kill in a `finally`)",
    ),
    "EX003": (
        "registration not removed on exception paths",
        "this function inserts into and removes from the same table, "
        "but an exception between the two skips the removal — the "
        "entry (a pending request, a collector) leaks and its waiter "
        "hangs forever; move the removal into a `finally`",
    ),
}

_OPENERS = frozenset({"open", "os.fdopen", "subprocess.Popen"})
_CLOSERS = frozenset({
    "close", "wait", "kill", "terminate", "release", "__exit__",
})
_REMOVERS = frozenset({"pop", "discard", "remove", "popitem", "clear"})


def _key_print(node: ast.AST) -> str | None:
    """A stable fingerprint for a table key expression: Name identity
    or constant value. Computed keys (slices, calls) return None —
    pairing them would be guesswork."""
    if isinstance(node, ast.Name):
        return f"n:{node.id}"
    if isinstance(node, ast.Constant):
        return f"c:{node.value!r}"
    return None


def _self_table(node: ast.AST) -> str | None:
    """``X`` when node is ``self.X`` (the table attribute)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _receiver_name(node: ast.AST) -> str | None:
    """Identity of a lock/handle receiver: bare name or self-attr."""
    if isinstance(node, ast.Name):
        return node.id
    t = _self_table(node)
    return f"self.{t}" if t is not None else None


def _stmts_between(fn: ast.AST, lo: int, hi: int,
                   kinds=ast.Call) -> list[ast.AST]:
    """Nodes of the given kinds strictly between two line bounds,
    nested defs excluded (they don't run here)."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        ln = getattr(node, "lineno", None)
        if ln is not None and lo < ln < hi and isinstance(node, kinds):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _finally_blocks(fn: ast.AST) -> list[tuple[ast.Try, int, int]]:
    """(try-node, body-start-line, body-end-line) for every try with a
    finalbody, nested defs excluded."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Try) and node.finalbody:
            end = max(
                getattr(s, "end_lineno", s.lineno) for s in node.body
            )
            out.append((node, node.body[0].lineno, end))
        stack.extend(ast.iter_child_nodes(node))
    return out


def _calls_in(nodes: list[ast.AST]) -> list[ast.Call]:
    out = []
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Call):
                out.append(sub)
    return out


class ExceptionSafetyPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        for module in modules:
            if module.root_kind == "tests":
                continue
            index = qualname_index(module.tree)
            for qual, fn in walk_functions(module.tree):
                finals = _finally_blocks(fn)
                self._ex001(module, index, fn, finals, findings)
                self._ex002(module, index, fn, finals, findings)
                self._ex003(module, index, fn, finals, findings)
        return findings

    # -- EX001: bare acquire -----------------------------------------------

    def _ex001(self, module, index, fn, finals, findings) -> None:
        for node in _own_nodes(fn):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
            ):
                continue
            recv = _receiver_name(node.func.value)
            if recv is None:
                continue
            if self._released_in_finally(fn, node, recv, finals):
                continue
            findings.append(Finding(
                path=module.repo_rel, line=node.lineno, rule="EX001",
                symbol=symbol_at(index, node.lineno),
                message=(
                    f"{recv}.acquire() without release guaranteed in a "
                    "finally — an exception leaves the lock held; use "
                    f"`with {recv}:`"
                ),
            ))

    def _released_in_finally(self, fn, node, recv, finals) -> bool:
        """Is there a try/finally whose finalbody calls
        ``recv.release()`` and whose body covers the acquisition — or
        that starts right after it with nothing raising in between?"""
        for t, lo, hi in finals:
            if not any(
                isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr == "release"
                and _receiver_name(c.func.value) == recv
                for fb in t.finalbody
                for c in ast.walk(fb)
            ):
                continue
            if lo <= node.lineno <= hi:
                return True  # acquired inside the protected body
            if node.lineno < lo:
                # acquire-then-try: safe when no call between the
                # acquire and the protected region can raise
                end = getattr(node, "end_lineno", node.lineno)
                if not _calls_in(_stmts_between(fn, end, lo)):
                    return True
        return False

    # -- EX002: leaked handles ---------------------------------------------

    def _ex002(self, module, index, fn, finals, findings) -> None:
        for node in _own_nodes(fn):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            cn = call_name(node.value)
            if cn not in _OPENERS:
                continue
            name = node.targets[0].id
            if self._escapes_or_closed(fn, node, name, finals):
                continue
            findings.append(Finding(
                path=module.repo_rel, line=node.lineno, rule="EX002",
                symbol=symbol_at(index, node.lineno),
                message=(
                    f"{cn}() bound to {name!r} is neither with-managed "
                    "nor closed in a finally — the handle leaks when an "
                    "exception fires"
                ),
            ))

    def _escapes_or_closed(self, fn, assign, name, finals) -> bool:
        after = assign.lineno
        closed_plain = False
        for node in _own_nodes(fn):
            ln = getattr(node, "lineno", 0)
            if ln <= after:
                continue
            # with-managed later: `with x:` / contextlib.closing(x)
            if isinstance(node, ast.With):
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        if isinstance(sub, ast.Name) and sub.id == name:
                            return True
            if isinstance(node, ast.Return) and node.value is not None:
                if any(
                    isinstance(s, ast.Name) and s.id == name
                    for s in ast.walk(node.value)
                ):
                    return True  # ownership transferred to the caller
            if isinstance(node, ast.Assign):
                if any(
                    isinstance(s, ast.Name) and s.id == name
                    for t in node.targets for s in ast.walk(t)
                ) or (
                    _self_table(node.targets[0]) is not None
                    and any(
                        isinstance(s, ast.Name) and s.id == name
                        for s in ast.walk(node.value)
                    )
                ):
                    return True  # stored: lifetime managed elsewhere
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _CLOSERS
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == name
                ):
                    if self._in_a_finally(fn, node, finals):
                        return True
                    closed_plain = True
                    continue
        if closed_plain:
            # closed, but only on the happy path: safe only when
            # nothing between open and close can raise
            closes = [
                n for n in ast.walk(fn)
                if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _CLOSERS
                and isinstance(n.func.value, ast.Name)
                and n.func.value.id == name
            ]
            last = max(c.lineno for c in closes)
            between = [
                c for c in _stmts_between(fn, assign.lineno, last)
                if not (
                    isinstance(c.func, ast.Attribute)
                    and isinstance(c.func.value, ast.Name)
                    and c.func.value.id == name
                )
            ]
            return not between
        return False

    def _in_a_finally(self, fn, node, finals) -> bool:
        for t, _lo, _hi in finals:
            for fb in t.finalbody:
                for sub in ast.walk(fb):
                    if sub is node:
                        return True
        return False

    # -- EX003: exactly-once registrations ---------------------------------

    def _ex003(self, module, index, fn, finals, findings) -> None:
        # (table attr, key fingerprint) -> nodes. The key must match
        # between insert and removal: `pop(token)` pairs with
        # `self.X[token] = v`, while `popitem()` / `pop(oldest)` is
        # LRU *eviction* of some other entry — not this entry's
        # removal, and eviction-only tables (caches, dedup rings) are
        # exactly the ones whose entries are SUPPOSED to outlive the
        # inserting call.
        inserts: dict[tuple[str, str], list[ast.AST]] = {}
        removals: dict[tuple[str, str], list[ast.AST]] = {}
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        table = _self_table(t.value)
                        key = _key_print(t.slice)
                        if table is not None and key is not None:
                            inserts.setdefault(
                                (table, key), []
                            ).append(node)
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        table = _self_table(t.value)
                        key = _key_print(t.slice)
                        if table is not None and key is not None:
                            removals.setdefault(
                                (table, key), []
                            ).append(node)
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REMOVERS
                and node.args
            ):
                table = _self_table(node.func.value)
                key = _key_print(node.args[0])
                if table is not None and key is not None:
                    removals.setdefault((table, key), []).append(node)
        # `self._cache[i] = self._cache.pop(i)` (LRU refresh) embeds
        # its pop INSIDE the insert — that's one atomic move, not a
        # paired removal
        for pair in list(removals):
            removals[pair] = [
                r for r in removals[pair]
                if not any(
                    any(sub is r for sub in ast.walk(ins))
                    for ins in inserts.get(pair, ())
                )
            ]
        for pair in sorted(set(inserts) & set(removals)):
            table = pair[0]
            if not removals[pair]:
                continue
            for ins in sorted(inserts[pair], key=lambda n: n.lineno):
                if self._insert_safe(fn, ins, table, removals[pair],
                                     finals):
                    continue
                findings.append(Finding(
                    path=module.repo_rel, line=ins.lineno, rule="EX003",
                    symbol=symbol_at(index, ins.lineno),
                    message=(
                        f"self.{table} entry inserted here but the "
                        "removal below is not exception-safe — a raise "
                        "in between leaks the entry; move the removal "
                        "into a finally"
                    ),
                ))

    def _insert_safe(self, fn, ins, table, removals, finals) -> bool:
        ins_end = getattr(ins, "end_lineno", ins.lineno)
        for rem in removals:
            rem_ln = rem.lineno
            if rem_ln <= ins_end:
                continue
            # removal inside a finally whose try body starts after the
            # insert: every raising statement between insert and
            # removal must be inside that protected body
            protecting = None
            for t, lo, hi in finals:
                if any(
                    sub is rem for fb in t.finalbody
                    for sub in ast.walk(fb)
                ):
                    protecting = (t, lo, hi)
                    break
            if protecting is not None:
                t, lo, hi = protecting
                unprotected = _calls_in(
                    _stmts_between(fn, ins_end, lo)
                )
                if not unprotected:
                    return True
                continue
            # plain removal: safe only when nothing between can raise
            between = _calls_in(_stmts_between(fn, ins_end, rem_ln))
            between = [
                c for c in between
                if not (
                    isinstance(c.func, ast.Attribute)
                    and c.func.attr in _REMOVERS
                    and _self_table(c.func.value) == table
                )
            ]
            if not between:
                return True
        return False
