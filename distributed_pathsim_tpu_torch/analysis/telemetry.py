"""Telemetry-discipline pass: obs/ stays the only reporting door.

Migrated from scripts/lint_telemetry.py (R2, R3); the wall-clock rule
became determinism.DT003 and the print/stream rules became
wire.WC003/WC004, so the old script's whole rule set lives on across
the unified passes (see MIGRATED_RULES in registry.py).

- **TL001 raw-stderr-print**: ``print(..., file=sys.stderr)`` outside
  the CLI surface and utils/logging.py. Library code reporting through
  raw stderr is invisible to the JSONL sink and the obs counters, and
  interleaves mid-line across threads — that's what ``runtime_event``
  exists for.
- **TL002 event-sink-bypass**: ``_EVENT_SINK`` referenced outside
  utils/logging.py — writing the sink directly skips the lock, the obs
  event counter, and the stderr echo policy.
"""

from __future__ import annotations

import ast

from .astutil import is_print_call, print_stream
from .core import Finding, Module, qualname_index, symbol_at

RULE_DOCS = {
    "TL001": (
        "raw stderr print in library code",
        "library code reports through runtime_event() (JSONL sink + "
        "obs counter + locked stderr), not raw stderr prints",
    ),
    "TL002": (
        "_EVENT_SINK accessed outside utils/logging.py",
        "the event sink is private to utils/logging.py — emitting "
        "through it directly skips the lock and the obs counters; "
        "call runtime_event()",
    ),
}

_STDERR_ALLOWED = frozenset({
    "utils/logging.py", "cli.py", "serving/cli.py", "neural_cli.py",
    "router/cli.py", "index/cli.py", "analysis/cli.py", "batch/cli.py",
})
_SINK_ALLOWED = frozenset({"utils/logging.py"})


class TelemetryPass:
    rules = RULE_DOCS

    def run(self, modules: list[Module]) -> list[Finding]:
        findings: list[Finding] = []
        for m in modules:
            if m.root_kind != "package":
                continue
            index = None
            if m.rel not in _STDERR_ALLOWED:
                for node in m.nodes:
                    if is_print_call(node) and print_stream(node) == "stderr":
                        if index is None:
                            index = qualname_index(m.tree)
                        findings.append(Finding(
                            path=m.repo_rel, line=node.lineno,
                            rule="TL001",
                            symbol=symbol_at(index, node.lineno),
                            message=(
                                "print(..., file=sys.stderr) in library "
                                "code — use runtime_event()"
                            ),
                        ))
            if m.rel not in _SINK_ALLOWED:
                for node in m.nodes:
                    if (
                        isinstance(node, (ast.Name, ast.Attribute))
                        and getattr(node, "id", getattr(node, "attr", None))
                        == "_EVENT_SINK"
                    ):
                        if index is None:
                            index = qualname_index(m.tree)
                        findings.append(Finding(
                            path=m.repo_rel, line=node.lineno,
                            rule="TL002",
                            symbol=symbol_at(index, node.lineno),
                            message=(
                                "_EVENT_SINK is private to "
                                "utils/logging.py — call runtime_event()"
                            ),
                        ))
        return findings
