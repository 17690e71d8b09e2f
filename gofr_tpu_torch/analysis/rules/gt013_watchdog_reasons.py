"""GT013 watchdog-reason drift: evidence must name a real signal.

The watchdog's reason strings, the whyz verdict evidence, and the
burn-plane verdicts all *name their source*: a ``signal`` entry that an
operator greps for on /debug/timez or /metrics. Nothing at runtime
validates those names — a renamed TimeSeriesStore signal silently turns
every verdict that cites it into fiction ("queue_depth anomaly" when
the signal is now ``queue_depth_v2``). The drift is invisible until an
incident, which is exactly when the evidence must be trustworthy.

Contract enforced statically:

1. *Usages* — any **literal** signal reference: a ``signal="..."``
   keyword argument, or a ``{"signal": "..."}`` dict-literal entry.
   Dynamic references (``signal=name``) are skipped — the lint is
   intentionally conservative; record-local facts use ``"field"`` keys,
   which are never checked.
2. *Allowances* — names a usage may cite:
   - literal first arguments to ``.register(...)`` calls (the
     TimeSeriesStore single-signal registration);
   - string constants inside the name collection passed to
     ``register_provider(...)`` — resolved through same-module name
     assignments and ``.extend``/``.append`` mutations, with f-string
     names contributing their leading constant as a *prefix* allowance
     (``f"queue_{cls}"`` allows any ``queue_*`` citation);
   - documented ``app_*`` metric names from the metrics catalog
     (``docs/quick-start/observability.md``), same source GT005 gates
     against.

A literal usage matching no allowance is a finding; suppress a
deliberate exception with ``# graftcheck: ignore[GT013]``.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, ROOT, Rule

DOCS_CATALOG = ROOT / "docs" / "quick-start" / "observability.md"
DOC_NAME_RE = re.compile(r"\bapp_[a-zA-Z0-9_]+\b")

_REGISTER_SINGLE = "register"
_REGISTER_MANY = "register_provider"
_MUTATORS = {"extend", "append"}
_MAX_RESOLVE_DEPTH = 4


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class WatchdogReasonDriftRule(Rule):
    rule_id = "GT013"
    title = "watchdog-signal-drift"
    severity = "error"
    cross_file = True  # finalize joins documented vs used reasons repo-wide

    def config_fingerprint(self) -> str:
        try:
            import hashlib
            digest = hashlib.sha256(
                self.docs_catalog.read_bytes()).hexdigest()[:16]
        except OSError:
            digest = "missing"
        return f"{self.rule_id}:{digest}"

    def __init__(self, docs_catalog: Optional[pathlib.Path] = None):
        self.docs_catalog = pathlib.Path(docs_catalog or DOCS_CATALOG)
        self._exact: Set[str] = set()
        self._prefixes: Set[str] = set()
        self._usages: List[Tuple[str, int, str]] = []  # (path, line, name)

    # -- allowance collection (per module) ----------------------------------
    def _collect_allowances(self, module: ModuleInfo) -> None:
        assigns: Dict[str, List[ast.AST]] = {}
        mutations: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigns.setdefault(node.targets[0].id, []).append(node.value)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS and \
                    isinstance(node.func.value, ast.Name):
                mutations.setdefault(
                    node.func.value.id, []).extend(node.args)

        def collect(value: ast.AST, depth: int = 0) -> None:
            if depth > _MAX_RESOLVE_DEPTH:
                return
            text = _literal_str(value)
            if text is not None:
                self._exact.add(text)
            elif isinstance(value, ast.JoinedStr):
                # f"queue_{cls}": the leading constant is a prefix
                # allowance; an f-string with no literal head adds
                # nothing (conservative: no allowance, not a finding)
                if value.values:
                    head = _literal_str(value.values[0])
                    if head:
                        self._prefixes.add(head)
            elif isinstance(value, (ast.List, ast.Tuple, ast.Set)):
                for elt in value.elts:
                    collect(elt, depth + 1)
            elif isinstance(value, (ast.ListComp, ast.SetComp,
                                    ast.GeneratorExp)):
                collect(value.elt, depth + 1)
            elif isinstance(value, ast.Call) and \
                    isinstance(value.func, ast.Name) and \
                    value.func.id in ("list", "tuple", "sorted", "set"):
                for arg in value.args:
                    collect(arg, depth + 1)
            elif isinstance(value, ast.Name):
                for assigned in assigns.get(value.id, ()):
                    collect(assigned, depth + 1)
                for arg in mutations.get(value.id, ()):
                    collect(arg, depth + 1)

        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.args):
                continue
            if node.func.attr == _REGISTER_SINGLE:
                # only literal first args: plenty of unrelated
                # .register() methods take non-string firsts
                name = _literal_str(node.args[0])
                if name is not None:
                    self._exact.add(name)
            elif node.func.attr == _REGISTER_MANY:
                collect(node.args[0])

    # -- usage collection (per module) --------------------------------------
    def _collect_usages(self, module: ModuleInfo) -> None:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                for keyword in node.keywords:
                    if keyword.arg != "signal":
                        continue
                    name = _literal_str(keyword.value)
                    if name is not None:
                        self._usages.append(
                            (module.relpath, keyword.value.lineno, name))
            elif isinstance(node, ast.Dict):
                for key, value in zip(node.keys, node.values):
                    if key is None or _literal_str(key) != "signal":
                        continue
                    name = _literal_str(value)
                    if name is not None:
                        self._usages.append(
                            (module.relpath, value.lineno, name))

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        self._collect_allowances(module)
        self._collect_usages(module)
        return []   # allowances span modules: judged in finalize

    def finalize(self, modules) -> Iterable[Finding]:
        documented: Set[str] = set()
        try:
            documented = set(DOC_NAME_RE.findall(
                self.docs_catalog.read_text(encoding="utf-8")))
        except OSError:
            pass   # GT005 already reports an unreadable catalog
        findings: List[Finding] = []
        for rel, lineno, name in self._usages:
            if name in self._exact or name in documented:
                continue
            if any(name.startswith(prefix) for prefix in self._prefixes):
                continue
            findings.append(Finding(
                rule=self.rule_id, path=rel, line=lineno,
                message=(
                    f"evidence cites signal {name!r} but no "
                    f"TimeSeriesStore registration or documented app_* "
                    f"metric carries that name — the verdict would "
                    f"point operators at a signal that does not exist"),
                severity=self.severity,
                key=f"unknown signal '{name}'"))
        return findings
