"""Finding reporters: human text, machine JSON, and SARIF for CI.

Text goes to reviewers and CI logs (one grep-able line per finding, the
same ``path:line:col:`` shape compilers use, so editors jump to it). JSON
is the stable machine surface — its shape is the JAX package's
(tests/test_torch_analysis.py holds the two equal), so downstream tooling
can read either tool's report.
SARIF 2.1.0 (``--format sarif``) is the lingua franca CI annotation
surface (GitHub code scanning et al.): unwaived findings become results,
waived ones carry an ``inSource`` suppression so they render as
acknowledged rather than vanish. Waived findings are REPORTED in every
format, not hidden: a waiver is an argued exception, and the reason
string travels with the finding so audits don't need to open the source.
"""

from __future__ import annotations

import json
from collections import Counter

from .core import RULES, AnalysisResult

__all__ = ["render_rule_docs", "render_text", "render_json", "render_sarif"]

# v2: findings gained "trace" (interprocedural call-path, null for
# per-file findings) when --project mode landed.
JSON_SCHEMA_VERSION = 2


def render_text(result: AnalysisResult, show_waived: bool = False) -> str:
    lines = []
    for f in result.findings:
        if f.waived and not show_waived:
            continue
        tag = " (waived: %s)" % (f.waiver_reason or "no reason given") if f.waived else ""
        trace = (
            " [call path: %s]" % " -> ".join(f.trace) if f.trace else ""
        )
        lines.append(
            f"{f.file}:{f.line}:{f.col + 1}: {f.rule} {f.severity}: "
            f"{f.message}{tag}{trace}"
        )
    for w in result.unused_waivers:
        lines.append(
            f"{w.file}:{w.line}: note: waiver for "
            f"{','.join(sorted(w.rules))} matched no finding — stale? "
            "(does not gate)"
        )
    n_unwaived = len(result.unwaived)
    n_waived = len(result.waived)
    lines.append(
        f"torchlint: {n_unwaived} finding(s) "
        f"({n_waived} waived) in {result.files_analyzed} file(s)"
    )
    return "\n".join(lines)


def _md_cell(text: str) -> str:
    return " ".join(str(text).split()).replace("|", "\\|")


def render_rule_docs() -> str:
    """The README rule-catalog table, generated from the registries so the
    docs can never drift from the code (``--rule-docs``;
    tests/test_torch_analysis.py diffs this against README.md's marked
    block of the port's catalog).
    Project-scope rules are tagged in the severity column; ``doc_why`` is
    each rule's third-column rationale."""
    from .conf_rules import CONF_RULES

    lines = [
        "| Rule | Severity | Catches | Why it matters on the GPU |",
        "|---|---|---|---|",
    ]

    def row(rule, project: bool) -> None:
        sev = rule.severity + (" (project)" if project else "")
        lines.append(
            f"| `{rule.id}` | {sev} | {_md_cell(rule.description)} | "
            f"{_md_cell(rule.doc_why)} |"
        )

    for rid in sorted(RULES):
        row(RULES[rid], RULES[rid].project_only)
    for rid in sorted(CONF_RULES):
        row(CONF_RULES[rid], True)
    return "\n".join(lines) + "\n"


def render_json(result: AnalysisResult) -> str:
    by_rule = Counter(f.rule for f in result.unwaived)
    payload = {
        "version": JSON_SCHEMA_VERSION,
        "files_analyzed": result.files_analyzed,
        "summary": {
            "unwaived": len(result.unwaived),
            "waived": len(result.waived),
            "by_rule": dict(sorted(by_rule.items())),
        },
        "findings": [f.as_dict() for f in result.findings],
        "unused_waivers": [w.as_dict() for w in result.unused_waivers],
    }
    return json.dumps(payload, indent=2, sort_keys=False)


_SARIF_LEVELS = {"error": "error", "warning": "warning"}


def render_sarif(result: AnalysisResult) -> str:
    """SARIF 2.1.0, the minimal schema CI annotators consume."""
    from .conf_rules import CONF_RULES

    catalog = {**{r.id: r for r in RULES.values()}, **CONF_RULES}
    seen_rules = sorted({f.rule for f in result.findings})
    rules = [
        {
            "id": rid,
            "shortDescription": {
                "text": getattr(catalog.get(rid), "description", "") or rid
            },
        }
        for rid in seen_rules
    ]
    rule_index = {rid: i for i, rid in enumerate(seen_rules)}
    results = []
    for f in result.findings:
        entry = {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": _SARIF_LEVELS.get(f.severity, "warning"),
            "message": {
                "text": f.message
                + (
                    " [call path: %s]" % " -> ".join(f.trace)
                    if f.trace
                    else ""
                )
            },
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.file},
                        "region": {
                            "startLine": f.line,
                            "startColumn": f.col + 1,
                        },
                    }
                }
            ],
        }
        if f.waived:
            entry["suppressions"] = [
                {
                    "kind": "inSource",
                    "justification": f.waiver_reason or "no reason given",
                }
            ]
        results.append(entry)
    payload = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
            "Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "torchlint",
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(payload, indent=2, sort_keys=False)
