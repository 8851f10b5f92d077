"""SARIF 2.1.0 export: `dpathsim-torch lint --sarif` for CI annotations.

One run, one tool (``dpathsim-torch-lint``), the full rule catalog as
``rules`` (so viewers render titles and help text), one ``result`` per
non-baselined finding and one *suppressed* result per baselined one
(SARIF's own suppression model — CI dashboards can show what the
baseline is carrying). Deterministic: sorted findings in, sorted keys
out, no timestamps — the artifact diffs like the JSON renderer does.
"""

from __future__ import annotations

import json

_SARIF_VERSION = "2.1.0"
_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _result(f, suppressed: bool) -> dict:
    out = {
        "ruleId": f.rule,
        "level": "error" if f.severity == "error" else "warning",
        "message": {"text": f"{f.symbol}: {f.message}"},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": max(int(f.line), 1)},
            },
            "logicalLocations": [{"fullyQualifiedName": f.symbol}],
        }],
    }
    if suppressed:
        out["suppressions"] = [{
            "kind": "external",
            "justification": (
                "baselined in distributed_pathsim_tpu_torch/analysis/"
                "baseline.json (every entry carries a reason and loud "
                "expiry)"
            ),
        }]
    return out


def render_sarif(result: dict) -> str:
    """``result`` is :func:`~.core.run_analysis` output."""
    from .registry import RULES

    rules = [
        {
            "id": rid,
            "name": RULES[rid].title,
            "shortDescription": {"text": RULES[rid].title},
            "fullDescription": {"text": RULES[rid].why},
            "properties": {"pass": RULES[rid].pass_name},
        }
        for rid in sorted(RULES)
    ]
    # the synthetic BASELINE rule (expired/stale suppressions) has no
    # registry entry but can appear in findings
    rules.append({
        "id": "BASELINE",
        "name": "baseline bookkeeping error",
        "shortDescription": {"text": "baseline bookkeeping error"},
        "fullDescription": {"text": (
            "an expired suppression (fix the finding or renew it) or a "
            "stale one matching nothing (delete it)"
        )},
        "properties": {"pass": "core"},
    })
    doc = {
        "$schema": _SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "dpathsim-torch-lint",
                "informationUri": (
                    "https://github.com/example/distributed-pathsim-tpu"
                ),
                "rules": rules,
            }},
            "columnKind": "utf16CodeUnits",
            "results": (
                [_result(f, False) for f in result["findings"]]
                + [_result(f, True) for f in result["suppressed"]]
            ),
        }],
    }
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"
