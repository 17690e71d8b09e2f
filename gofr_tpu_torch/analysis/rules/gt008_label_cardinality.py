"""GT008 metric-label-cardinality: unbounded values fed into metric labels.

Every distinct label value materializes a new time series in the metrics
Manager (and in whatever scrapes it). A label fed from a per-request
identifier — ``trace_id``, ``request_id``, a handoff id, a raw URL path —
grows without bound: memory climbs request-by-request, scrape payloads
bloat, and downstream aggregation (``sum by (...)``) silently stops
meaning anything. The fleet rollups lean on label sets
staying small (model, slo class, replica, reason, bucket), so the
cardinality discipline becomes a machine-checked invariant here.

Detection: every ``increment_counter`` / ``delta_updown_counter`` /
``record_histogram`` / ``set_gauge`` call site's **label keyword
arguments** are classified by the terminal identifier feeding the value —
looked through ``str(...)``, f-strings, ``%``/``+`` composition and
constant-string subscripts. A label is flagged when

- that identifier is a known per-request name (``trace_id``, ``span_id``,
  ``request_id``, ``req_id``, ``handoff``/``handoff_id``, ``uuid*``,
  ``correlation_id``, ``traceparent``, ``session_id``), or
- it is ``.path`` read off a request-shaped receiver (``ctx`` /
  ``request`` / ``req``) — raw URL paths carry embedded ids, or
- the *label name itself* is one of the per-request names (whatever
  feeds ``trace_id=...`` will be per-request).

The ``exemplar`` keyword is exempt by design: exemplars are the
sanctioned channel for attaching a trace id to an observation without
minting a series per request. Positional args and ``**labels`` splats
are out of scope (the lint is intentionally conservative). Suppress a
justified bounded case with ``# graftcheck: ignore[GT008]``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule
from gofr_tpu_torch.analysis.rules.gt005_metrics import OBSERVE_METHODS

# identifiers that are per-request by construction, wherever they appear
UNBOUNDED_NAMES = {
    "trace_id", "span_id", "request_id", "req_id",
    "handoff", "handoff_id", "uuid", "uuid1", "uuid4", "hex",
    "correlation_id", "traceparent", "session_id",
}

# receivers whose ``.path`` attribute is a raw URL path
PATH_RECEIVERS = {"ctx", "request", "req"}


class LabelCardinalityRule(Rule):
    rule_id = "GT008"
    title = "metric-label-cardinality"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in OBSERVE_METHODS:
                continue
            metric = "?"
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                metric = node.args[0].value
            for kw in node.keywords:
                if kw.arg is None or kw.arg == "exemplar":
                    continue
                culprit = self._unbounded_source(kw.value)
                if culprit is None and kw.arg in UNBOUNDED_NAMES:
                    culprit = f"label named {kw.arg!r}"
                if culprit is None:
                    continue
                findings.append(Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"metric-label-cardinality: label {kw.arg!r} on "
                        f"{metric!r} is fed from an unbounded value "
                        f"({culprit}) — every distinct value mints a new "
                        f"time series; use a bounded label and carry "
                        f"per-request ids in the exemplar or span instead"),
                    severity=self.severity,
                    key=f"{kw.arg} on {metric}",
                ))
        return findings

    # -- value classification ------------------------------------------------
    def _unbounded_source(self, expr: ast.AST) -> Optional[str]:
        for ident, receiver in self._terminal_idents(expr):
            if ident in UNBOUNDED_NAMES:
                return f"derived from {ident!r}"
            if ident == "path" and receiver in PATH_RECEIVERS:
                return f"raw request path off {receiver!r}"
        return None

    def _terminal_idents(
            self, expr: ast.AST) -> List[Tuple[str, Optional[str]]]:
        """The identifiers a label value is built from, looked through
        string composition. Each entry is ``(name, receiver-or-None)``."""
        out: List[Tuple[str, Optional[str]]] = []
        if isinstance(expr, ast.Name):
            out.append((expr.id, None))
        elif isinstance(expr, ast.Attribute):
            base = expr.value
            receiver = None
            if isinstance(base, ast.Name):
                receiver = base.id
            elif isinstance(base, ast.Attribute):
                receiver = base.attr
            out.append((expr.attr, receiver))
        elif isinstance(expr, ast.Subscript):
            key = expr.slice
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                out.append((key.value, None))
        elif isinstance(expr, ast.Call):
            # str(x) / "{}".format(x) / f"{x}".join — look through to the
            # operands; also catch uuid.uuid4()-style generator calls
            if isinstance(expr.func, ast.Name):
                out.append((expr.func.id, None))
            elif isinstance(expr.func, ast.Attribute):
                out.append((expr.func.attr, None))
            for arg in expr.args:
                out.extend(self._terminal_idents(arg))
        elif isinstance(expr, ast.JoinedStr):
            for value in expr.values:
                if isinstance(value, ast.FormattedValue):
                    out.extend(self._terminal_idents(value.value))
        elif isinstance(expr, ast.BinOp):
            out.extend(self._terminal_idents(expr.left))
            out.extend(self._terminal_idents(expr.right))
        elif isinstance(expr, (ast.IfExp,)):
            out.extend(self._terminal_idents(expr.body))
            out.extend(self._terminal_idents(expr.orelse))
        return out
