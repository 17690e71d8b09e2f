"""SARIF 2.1.0 emitter for graftcheck reports.

CI annotates PRs from a standard artifact instead of scraping stderr:
``python -m gofr_tpu_torch.analysis --sarif out.sarif``. The tool is
named ``graftcheck-torch`` so that a report says which tree it scanned. Only *new* findings become ``results`` — baselined and
pragma-suppressed findings are the accepted state of the tree, not
review items; parse errors surface as tool execution notifications so
a broken file fails visibly in the same artifact.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Sequence

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

TOOL_NAME = "graftcheck-torch"

_LEVELS = {"error": "error", "warning": "warning", "note": "note"}


def report_to_sarif(report, rules: Sequence[object]) -> Dict:
    rule_meta = []
    seen = set()
    for rule in rules:
        rule_id = getattr(rule, "rule_id", None)
        if rule_id is None or rule_id in seen:
            continue
        seen.add(rule_id)
        rule_meta.append({
            "id": rule_id,
            "name": getattr(rule, "title", "") or rule_id,
            "defaultConfiguration": {
                "level": _LEVELS.get(
                    getattr(rule, "severity", "error"), "error")},
            "helpUri": ("https://example.invalid/docs/references/"
                        "static-analysis-torch.md"),
        })

    results: List[Dict] = []
    for finding in report.new_findings:
        results.append({
            "ruleId": finding.rule,
            "level": _LEVELS.get(finding.severity, "error"),
            "message": {"text": finding.message},
            "partialFingerprints": {
                "graftcheck/v1": finding.fingerprint},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.path,
                        "uriBaseId": "SRCROOT"},
                    "region": {"startLine": max(1, finding.line)},
                },
            }],
        })

    notifications = [{
        "level": "error",
        "message": {"text": text},
    } for text in report.parse_errors]

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": TOOL_NAME,
                "informationUri": ("https://example.invalid/docs/"
                                   "references/static-analysis-torch.md"),
                "rules": rule_meta,
            }},
            "results": results,
            "invocations": [{
                "executionSuccessful": report.exit_code == 0,
                "toolExecutionNotifications": notifications,
            }],
            "columnKind": "utf16CodeUnits",
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
        }],
    }


def write_sarif(path: pathlib.Path, report, rules: Sequence[object]) -> None:
    payload = report_to_sarif(report, rules)
    pathlib.Path(path).write_text(
        json.dumps(payload, indent=2, sort_keys=False) + "\n",
        encoding="utf-8")
