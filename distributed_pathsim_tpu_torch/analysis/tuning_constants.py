"""Tuning-constants pass: no new hardcoded tile/bucket knobs.

The JAX package's contract (its scripts/lint_tuning.py, migrated):
any module-level or class-level integer (or all-integer-tuple)
constant whose name contains a tile/bucket/index-geometry token must
live in ``tuning/registry.py``, be the registered default of one of
its knobs (``registry.KNOB_DEFAULTS``), or be listed in
``registry.SANCTIONED_CONSTANTS`` with its justification. Everything
else is a knob trying to escape the registry — exactly how untuned
heuristics fossilize.

- **TN001 hardcoded-tuning-constant**.
"""

from __future__ import annotations

import ast
import re

from .core import Finding, Module

RULE_DOCS = {
    "TN001": (
        "hardcoded tile/bucket constant outside tuning/registry.py",
        "tile/bucket choices are tuning knobs: register it in "
        "tuning/registry.py (as a knob's default in KNOB_DEFAULTS, or "
        "sanctioned in SANCTIONED_CONSTANTS with a justification)",
    ),
}

_EXEMPT_PREFIXES = ("tuning/", "analysis/")
_TOKENS = {
    "TILE", "BUCKET", "LADDER", "STRIPE", "BM", "BN", "BK",
    "CAP", "CENTROID", "NPROBE",
}
_SPLIT = re.compile(r"[^A-Za-z0-9]+")


def _name_matches(name: str) -> bool:
    parts = {p.upper() for p in _SPLIT.split(name) if p}
    parts |= {p[:-1] for p in parts if p.endswith("S")}
    return bool(parts & _TOKENS)


def _is_const_int(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and not isinstance(
            node.value, bool
        )
    if isinstance(node, ast.Tuple):
        return bool(node.elts) and all(_is_const_int(e) for e in node.elts)
    if isinstance(node, ast.BinOp):
        return _is_const_int(node.left) and _is_const_int(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_const_int(node.operand)
    return False


def _const_assignments(tree: ast.Module):
    scopes: list[ast.AST] = [tree]
    scopes.extend(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef))
    for scope in scopes:
        for stmt in scope.body:  # type: ignore[attr-defined]
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgt, value = stmt.target, stmt.value
            else:
                continue
            if isinstance(tgt, ast.Name) and _is_const_int(value):
                yield tgt.id, stmt.lineno


def _sanctioned() -> dict:
    """rel path -> the constant names TN001 lets stand there: the
    registry's sanctioned constants, and the registered defaults of its
    knobs (a default whose knob the registry no longer registers is a
    stray constant again)."""
    from ..tuning.registry import KNOB_DEFAULTS, KNOBS, SANCTIONED_CONSTANTS

    out = {rel: set(names) for rel, names in SANCTIONED_CONSTANTS.items()}
    for rel, defaults in KNOB_DEFAULTS.items():
        out.setdefault(rel, set()).update(
            name for name, knob in defaults.items() if knob in KNOBS
        )
    return {rel: frozenset(names) for rel, names in sorted(out.items())}


def scan_modules(
    modules: list[Module], sanctioned: dict | None = None
) -> list[Finding]:
    if sanctioned is None:
        sanctioned = _sanctioned()
    findings: list[Finding] = []
    for m in modules:
        if m.root_kind != "package":
            continue
        if m.rel.startswith(_EXEMPT_PREFIXES):
            continue
        allowed = sanctioned.get(m.rel, frozenset())
        for name, line in _const_assignments(m.tree):
            if _name_matches(name) and name not in allowed:
                findings.append(Finding(
                    path=m.repo_rel, line=line, rule="TN001",
                    symbol=name,
                    message=(
                        f"hardcoded tile/bucket constant {name!r} — "
                        "register it in tuning/registry.py or sanction "
                        "it in SANCTIONED_CONSTANTS"
                    ),
                ))
    return findings


class TuningConstantsPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        return scan_modules(modules)
