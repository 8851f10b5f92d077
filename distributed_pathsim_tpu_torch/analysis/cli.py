"""``dpathsim-torch lint``: run the port's analyzer over the port, exit
nonzero on findings.

Usage::

    dpathsim-torch lint                     # all rules, baseline applied
    dpathsim-torch lint --rules LD101,LD102 # one family's rules only
    dpathsim-torch lint --json              # stable sorted JSON (diffable)
    dpathsim-torch lint --sarif PATH        # SARIF 2.1.0 for CI annotations
    dpathsim-torch lint --write-wire-schema # regenerate
                                            # artifacts/wire_schema_torch.json
    dpathsim-torch lint --no-baseline       # raw findings, suppressions off
    dpathsim-torch lint --no-cache          # skip the parse/mtime cache
    dpathsim-torch lint --list-rules        # the rule catalog, by family

(``dpathsim-torch`` is ``python -m distributed_pathsim_tpu_torch.cli``.)
Pure AST work: it builds no backend, launches no kernel and creates no
CUDA context.

Exit codes: 0 clean (baseline-suppressed findings don't fail), 1 any
non-baselined finding (including expired/stale baseline entries), 2
usage errors.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dpathsim-torch lint",
        description="unified invariant-checking static analysis "
        "(recompile-safety, lock-discipline + interprocedural "
        "lock-order, determinism, wire-contract + wire-schema gate, "
        "exception-safety; DESIGN.md §25/§27)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable output: sorted findings, sorted keys — "
        "byte-stable across runs for diffing",
    )
    p.add_argument(
        "--sarif", default=None, metavar="PATH",
        help="also write a SARIF 2.1.0 report (byte-stable; baselined "
        "findings ride along as suppressed results)",
    )
    p.add_argument(
        "--baseline", default=None,
        help="baseline/suppression file "
        "(default: distributed_pathsim_tpu_torch/analysis/baseline.json)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every finding",
    )
    p.add_argument(
        "--no-cache", action="store_true",
        help="bypass the parse/mtime cache (.lint_cache/)",
    )
    p.add_argument(
        "--write-wire-schema", action="store_true",
        help="regenerate artifacts/wire_schema_torch.json from the "
        "inferred wire contract and exit (commit the diff)",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog grouped by family and exit",
    )
    return p


def _list_rules() -> None:
    from .registry import ALL_PASSES, PASS_FAMILIES, RULES

    for p in ALL_PASSES:
        name = type(p).__name__
        family = PASS_FAMILIES.get(name, name)
        rids = sorted(p.rules)
        print(f"{family}:")
        for rid in rids:
            print(f"  {rid}  {RULES[rid].title}")
    print(
        "\nrun `dpathsim-torch lint --rules <ids>` for one subset; every "
        "rule's rationale is in the human report's `->` lines"
    )


def lint_main(argv: list[str] | None = None) -> int:
    from .cache import load_modules_cached
    from .core import (
        load_baseline,
        load_modules,
        render_human,
        render_json,
        run_analysis,
    )
    from .registry import RULES

    args = build_parser().parse_args(argv)
    if args.list_rules:
        _list_rules()
        return 0
    if args.write_wire_schema:
        return _write_wire_schema(args)
    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(RULES) - {"BASELINE"}
        if unknown:
            print(
                f"error: unknown rule(s) {sorted(unknown)}; see "
                "--list-rules", file=sys.stderr,
            )
            return 2
    baseline = None if args.no_baseline else load_baseline(args.baseline)
    if baseline is not None and rules is not None:
        # a rule filter must not turn the other rules' suppressions
        # into "stale entry" findings
        baseline = [e for e in baseline if e.get("rule") in rules]
    if args.no_cache:
        from .core import default_roots

        modules = load_modules(default_roots())
    else:
        modules = load_modules_cached()
    result = run_analysis(rules=rules, baseline=baseline, modules=modules)
    if args.sarif:
        from .sarif import render_sarif

        with open(args.sarif, "w", encoding="utf-8") as f:
            f.write(render_sarif(result))
    if args.json:
        print(render_json(result))
    else:
        print(render_human(result))
    return 1 if result["findings"] else 0


def _write_wire_schema(args) -> int:
    from .cache import load_modules_cached
    from .core import default_roots, load_modules
    from .wireschema import infer_schema, render_schema, schema_path_for

    modules = (
        load_modules(default_roots()) if args.no_cache
        else load_modules_cached()
    )
    schema = infer_schema(modules)
    if schema is None:
        print(
            "error: no serving/protocol.py with PROTOCOL_OPS in the "
            "analyzed tree", file=sys.stderr,
        )
        return 2
    path = schema_path_for(modules)
    if path is None:
        print("error: cannot locate artifacts/", file=sys.stderr)
        return 2
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(render_schema(schema), encoding="utf-8")
    ops = len(schema["ops"])
    print(f"wrote {path} ({ops} ops)")
    return 0
