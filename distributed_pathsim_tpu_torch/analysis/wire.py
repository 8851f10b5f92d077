"""Wire-contract pass: the JSONL protocol stays evolvable and clean.

- **WC001 unregistered-protocol-op**: every op string
  ``serving/protocol._dispatch_op`` compares against must appear in
  ``PROTOCOL_OPS`` — the registry the request-id-echo test iterates —
  and the router's ``ROUTED_OPS`` must be a subset of it. An
  unregistered op is an op whose responses the router's retry/hedge/
  dedup machinery was never proven able to correlate. (Migrated from
  scripts/lint_telemetry.py R8.)
- **WC002 undefaulted-wire-field**: reads of request/message dict
  fields in the protocol/router layer use ``.get(...)`` (or sit under
  an explicit ``.get``/``in`` guard). A bare ``req["field"]`` turns
  yesterday's clients — which don't send the new field — into
  KeyErrors; the protocol's compat story is "new fields are defaulted".
- **WC003 raw-print-on-wire-process**: ``print()`` anywhere in
  ``router/``, ``index/``, or ``obs/`` (CLI surfaces excepted):
  these packages run inside processes whose STDOUT IS the JSONL wire —
  a stray print corrupts the protocol stream. (Migrated R5/R6/R7.)
- **WC004 raw-stream-write**: ``sys.stdout.write``/``sys.stderr.write``
  outside utils/logging.py — skips the event sink's lock (stderr) or
  corrupts the wire (stdout). (Migrated R4.)
"""

from __future__ import annotations

import ast

from .astutil import call_name, dotted, is_print_call
from .core import Finding, Module, qualname_index, symbol_at

RULE_DOCS = {
    "WC001": (
        "protocol op handled but not registered in PROTOCOL_OPS",
        "PROTOCOL_OPS is the registry the request-id-echo test "
        "iterates — register the op so router retries/hedges/dedup are "
        "proven able to correlate its responses",
    ),
    "WC002": (
        "undefaulted wire-field read",
        "wire dicts are read with .get(...) (new fields must default) "
        "— a bare subscript breaks every client that predates the "
        "field",
    ),
    "WC003": (
        "print() in a package that owns the JSONL wire",
        "router/index/obs code runs in processes whose stdout IS the "
        "wire — report through runtime_event(); protocol lines go "
        "through the loop's locked writer",
    ),
    "WC004": (
        "raw sys.stdout/sys.stderr write",
        "direct stream writes skip the event sink's lock (stderr) or "
        "corrupt the JSONL wire (stdout); use runtime_event() or the "
        "locked protocol writer",
    ),
}

_PROTOCOL_FILE = "serving/protocol.py"
_ROUTER_OPS_FILE = "router/core.py"
_WIRE_READ_PREFIXES = ("serving/protocol.py", "router/")
_WIRE_NAMES = frozenset({"req", "obj", "msg", "wire"})
_PRINT_SCOPES = {
    "router/": frozenset({"router/cli.py"}),
    "index/": frozenset({"index/cli.py"}),
    "obs/": frozenset(),
}
_STREAM_WRITE_ALLOWED = frozenset({"utils/logging.py"})


def _frozenset_literal(tree: ast.Module, name: str) -> set[str] | None:
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == name
        ):
            out: set[str] = set()
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) and isinstance(
                    sub.value, str
                ):
                    out.add(sub.value)
            return out
    return None


class WireContractPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        by_rel = {m.rel: m for m in modules if m.root_kind == "package"}
        self._wc001(by_rel, findings)
        for m in modules:
            if m.root_kind != "package":
                continue
            if m.rel.startswith(_WIRE_READ_PREFIXES):
                self._wc002(m, findings)
            self._wc003(m, findings)
            self._wc004(m, findings)
        return findings

    def _wc001(self, by_rel: dict, findings: list[Finding]) -> None:
        proto = by_rel.get(_PROTOCOL_FILE)
        if proto is None:
            return  # not analyzing the package tree (fixture run)
        registered = _frozenset_literal(proto.tree, "PROTOCOL_OPS")
        if registered is None:
            findings.append(Finding(
                path=proto.repo_rel, line=1, rule="WC001",
                message=(
                    "PROTOCOL_OPS registry missing — protocol.py must "
                    "declare the op registry the request-id-echo test "
                    "iterates"
                ),
            ))
            registered = set()
        index = qualname_index(proto.tree)
        for node in ast.walk(proto.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not (
                isinstance(node.left, ast.Name) and node.left.id == "op"
            ):
                continue
            for op_node, cmp in zip(node.comparators, node.ops):
                if not isinstance(cmp, (ast.Eq,)):
                    continue
                consts = [
                    c.value for c in ast.walk(op_node)
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)
                ]
                for op in consts:
                    if op not in registered:
                        findings.append(Finding(
                            path=proto.repo_rel, line=node.lineno,
                            rule="WC001",
                            symbol=symbol_at(index, node.lineno),
                            message=(
                                f"op {op!r} handled but not registered "
                                "in PROTOCOL_OPS"
                            ),
                        ))
        router = by_rel.get(_ROUTER_OPS_FILE)
        if router is not None and registered:
            routed = _frozenset_literal(router.tree, "ROUTED_OPS") or set()
            for op in sorted(routed - registered):
                findings.append(Finding(
                    path=router.repo_rel, line=1, rule="WC001",
                    message=(
                        f"ROUTED_OPS entry {op!r} is not in "
                        "PROTOCOL_OPS — the router would dispatch an op "
                        "no worker registers"
                    ),
                ))

    def _wc002(self, m: Module, findings: list[Finding]) -> None:
        index = qualname_index(m.tree)

        def guarded(stack: list[ast.AST], name: str, field: str) -> bool:
            for anc in stack:
                if not isinstance(anc, (ast.If, ast.IfExp)):
                    continue
                for sub in ast.walk(anc.test):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "get"
                        and dotted(sub.func.value) == name
                        and sub.args
                        and isinstance(sub.args[0], ast.Constant)
                        and sub.args[0].value == field
                    ):
                        return True
                    if (
                        isinstance(sub, ast.Compare)
                        and isinstance(sub.left, ast.Constant)
                        and sub.left.value == field
                        and any(isinstance(o, ast.In) for o in sub.ops)
                        # the membership test must be against THIS dict
                        # — `"f" in other` guards nothing about req["f"]
                        and any(dotted(c) == name for c in sub.comparators)
                    ):
                        return True
            return False

        def visit(node: ast.AST, stack: list[ast.AST]) -> None:
            for child in ast.iter_child_nodes(node):
                if (
                    isinstance(child, ast.Subscript)
                    and isinstance(child.ctx, ast.Load)
                    and isinstance(child.value, ast.Name)
                    and child.value.id in _WIRE_NAMES
                    and isinstance(child.slice, ast.Constant)
                    and isinstance(child.slice.value, str)
                ):
                    field = child.slice.value
                    if not guarded(stack, child.value.id, field):
                        findings.append(Finding(
                            path=m.repo_rel, line=child.lineno,
                            rule="WC002",
                            symbol=symbol_at(index, child.lineno),
                            message=(
                                f"{child.value.id}[{field!r}] read "
                                "without a default — old clients don't "
                                f"send {field!r}; use .get() or guard "
                                "the read"
                            ),
                        ))
                visit(child, stack + [child])

        visit(m.tree, [])

    def _wc003(self, m: Module, findings: list[Finding]) -> None:
        for prefix, allowed in _PRINT_SCOPES.items():
            if not m.rel.startswith(prefix) or m.rel in allowed:
                continue
            index = qualname_index(m.tree)
            for node in m.nodes:
                if is_print_call(node):
                    findings.append(Finding(
                        path=m.repo_rel, line=node.lineno, rule="WC003",
                        symbol=symbol_at(index, node.lineno),
                        message=(
                            f"print() in {prefix} — this package runs "
                            "in processes whose stdout is the JSONL "
                            "wire; use runtime_event()"
                        ),
                    ))

    def _wc004(self, m: Module, findings: list[Finding]) -> None:
        if m.rel in _STREAM_WRITE_ALLOWED:
            return
        index = None
        for node in m.nodes:
            if (
                isinstance(node, ast.Attribute)
                and node.attr == "write"
                and dotted(node.value) in ("sys.stdout", "sys.stderr")
            ):
                if index is None:
                    index = qualname_index(m.tree)
                findings.append(Finding(
                    path=m.repo_rel, line=node.lineno, rule="WC004",
                    symbol=symbol_at(index, node.lineno),
                    message=(
                        f"{dotted(node.value)}.write() — skips the "
                        "event sink's lock / corrupts the wire; use "
                        "runtime_event() or the locked protocol writer"
                    ),
                ))
