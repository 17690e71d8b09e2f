"""GT005 metric discipline: the static metric-name lint as a graftcheck
rule.

The JAX package's rule, with one more way to register a name: the port
registers its catalog through tables (``ENGINE_METRICS`` and
``FRAMEWORK_METRICS`` handed to ``_register`` in ``metrics/catalog.py``),
so the first field of every row of a table that reaches a ``new_*``
registration counts as registered, and is held to checks 1-2 like a
literal. The checks:

1. every literal metric name matches the OpenMetrics charset
   ``[a-zA-Z_][a-zA-Z0-9_]*``;
2. every name carries the ``app_`` namespace prefix, except the
   intentionally-unprefixed process runtime gauges in
   ``ALLOW_UNPREFIXED``;
3. every observed name is registered somewhere in the scanned tree — a
   typo'd observation is silently dropped at runtime by Manager's
   error-log-and-continue policy, so it must fail CI instead;
4. every registered ``app_``-prefixed name appears in the metrics
   catalog (``docs/quick-start/observability.md`` by default) — the
   docs-drift gate.

Checks 1-2 are per-file findings (pragma-suppressible); 3-4 need the
whole tree and run in ``finalize``.

A registration table is a module-level tuple or list of tuples whose
rows start with a literal name, iterated by a ``for name, ... in table``
loop whose body registers ``name`` (``manager.new_histogram(name, ...)``
or ``getattr(manager, f"new_{kind}")(name, ...)``): directly, or through
a function of the same module that loops over its parameter and is
called with the table at that position.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable, List, Optional, Set, Tuple

from gofr_tpu_torch.analysis.engine import (
    Finding,
    ModuleInfo,
    ROOT,
    Rule,
)

DOCS_CATALOG = ROOT / "docs" / "quick-start" / "observability.md"

NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# any app_-namespaced token in the docs counts as "documented" — rows in
# the catalog table, prose mentions, and code samples all qualify
DOC_NAME_RE = re.compile(r"\bapp_[a-zA-Z0-9_]+\b")

# process-runtime gauges predating the app_ namespace convention; kept
# unprefixed for parity with common node-exporter dashboards
ALLOW_UNPREFIXED = {
    "threads_total",
    "memory_rss_bytes",
    "gc_objects",
    "uptime_seconds",
}

REGISTER_METHODS = {
    "new_counter",
    "new_updown_counter",
    "new_histogram",
    "new_gauge",
}
OBSERVE_METHODS = {
    "increment_counter",
    "delta_updown_counter",
    "record_histogram",
    "set_gauge",
}


def _metric_calls(tree: ast.AST):
    """Yield (method, name, lineno) for metrics calls with a literal
    first argument. Non-literal names (dynamic dispatch) are skipped —
    the lint is intentionally conservative."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute):
            continue
        method = func.attr
        if method not in REGISTER_METHODS | OBSERVE_METHODS:
            continue
        if not node.args:
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            yield method, first.value, node.lineno


def _registers(node: ast.AST, name: str) -> bool:
    """Does ``node`` hold a ``new_*`` registration call whose first
    argument is the bare name ``name``?"""
    for call in ast.walk(node):
        if not isinstance(call, ast.Call) or not call.args:
            continue
        first = call.args[0]
        if not (isinstance(first, ast.Name) and first.id == name):
            continue
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in REGISTER_METHODS:
            return True
        # getattr(manager, f"new_{kind}")(name, ...)
        if isinstance(func, ast.Call) and isinstance(func.func, ast.Name) \
                and func.func.id == "getattr" and len(func.args) >= 2:
            attr = func.args[1]
            text = (attr.values[0].value if isinstance(attr, ast.JoinedStr)
                    and attr.values and isinstance(attr.values[0],
                                                   ast.Constant)
                    else getattr(attr, "value", None))
            if isinstance(text, str) and text.startswith("new_"):
                return True
    return False


def _registering_loops(tree: ast.AST):
    """Yield (enclosing function or None, iterated expression) for every
    ``for name, ... in X`` loop whose body registers ``name``."""
    parents = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        target = node.target
        first = target.elts[0] if isinstance(target, ast.Tuple) \
            and target.elts else target
        if not isinstance(first, ast.Name):
            continue
        if not any(_registers(stmt, first.id) for stmt in node.body):
            continue
        fn = parents.get(node)
        while fn is not None and not isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = parents.get(fn)
        yield fn, node.iter


def _table_rows(tree: ast.AST):
    """Yield (name, lineno) for every row of every module-level
    registration table (see the module docstring)."""
    tables = {}
    for stmt in tree.body:
        target = value = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            target, value = stmt.targets[0], stmt.value
        elif isinstance(stmt, ast.AnnAssign):
            target, value = stmt.target, stmt.value
        if isinstance(target, ast.Name) and \
                isinstance(value, (ast.Tuple, ast.List)):
            tables[target.id] = value
    used = set()
    looped = {}   # function name -> positions of the iterated parameter
    for fn, iterated in _registering_loops(tree):
        if not isinstance(iterated, ast.Name):
            continue
        if iterated.id in tables:
            used.add(iterated.id)
        if fn is not None:
            params = [a.arg for a in fn.args.args]
            if iterated.id in params:
                looped.setdefault(fn.name, set()).add(
                    params.index(iterated.id))
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and
                isinstance(node.func, ast.Name) and
                node.func.id in looped):
            continue
        for index in looped[node.func.id]:
            if index < len(node.args) and \
                    isinstance(node.args[index], ast.Name) and \
                    node.args[index].id in tables:
                used.add(node.args[index].id)
    for table in sorted(used):
        for row in tables[table].elts:
            if isinstance(row, (ast.Tuple, ast.List)) and row.elts and \
                    isinstance(row.elts[0], ast.Constant) and \
                    isinstance(row.elts[0].value, str):
                yield row.elts[0].value, row.elts[0].lineno


class MetricDisciplineRule(Rule):
    rule_id = "GT005"
    title = "metric-discipline"
    severity = "error"
    cross_file = True  # finalize joins registered vs observed repo-wide

    def __init__(self, docs_catalog: Optional[pathlib.Path] = None):
        self.docs_catalog = pathlib.Path(docs_catalog or DOCS_CATALOG)
        self._registered: Set[str] = set()
        self._observed: List[Tuple[str, int, str]] = []  # (path, line, name)

    def config_fingerprint(self) -> str:
        # findings depend on the docs catalog, not just scanned sources
        try:
            import hashlib
            digest = hashlib.sha256(
                self.docs_catalog.read_bytes()).hexdigest()[:16]
        except OSError:
            digest = "missing"
        return f"{self.rule_id}:{digest}"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        rows = [("new_table_row", name, lineno)
                for name, lineno in _table_rows(module.tree)]
        for method, name, lineno in list(_metric_calls(module.tree)) + rows:
            if not NAME_RE.match(name):
                findings.append(Finding(
                    rule=self.rule_id, path=module.relpath, line=lineno,
                    message=(f"metric {name!r} violates the OpenMetrics "
                             f"charset [a-zA-Z_][a-zA-Z0-9_]*"),
                    key=f"charset {name}"))
            if not name.startswith("app_") and name not in ALLOW_UNPREFIXED:
                findings.append(Finding(
                    rule=self.rule_id, path=module.relpath, line=lineno,
                    message=(f"metric {name!r} missing the app_ namespace "
                             f"prefix (or add it to ALLOW_UNPREFIXED)"),
                    key=f"prefix {name}"))
            if method in REGISTER_METHODS or method == "new_table_row":
                self._registered.add(name)
            else:
                self._observed.append((module.relpath, lineno, name))
        return findings

    def finalize(self, modules) -> Iterable[Finding]:
        findings: List[Finding] = []
        for rel, lineno, name in self._observed:
            if name not in self._registered:
                findings.append(Finding(
                    rule=self.rule_id, path=rel, line=lineno,
                    message=(f"metric {name!r} is observed but never "
                             f"registered — Manager drops it at runtime"),
                    key=f"unregistered {name}"))
        try:
            documented = set(DOC_NAME_RE.findall(
                self.docs_catalog.read_text(encoding="utf-8")))
        except OSError as exc:
            docs_rel = self._docs_rel()
            return findings + [Finding(
                rule=self.rule_id, path=docs_rel, line=1,
                message=f"unreadable metrics catalog: {exc}",
                key="catalog unreadable")]
        docs_rel = self._docs_rel()
        for name in sorted(self._registered):
            if name.startswith("app_") and name not in documented:
                findings.append(Finding(
                    rule=self.rule_id, path=docs_rel, line=1,
                    message=(f"metric {name!r} is registered in source "
                             f"but missing from the metrics catalog — "
                             f"document it (or remove the registration)"),
                    key=f"undocumented {name}"))
        return findings

    def _docs_rel(self) -> str:
        try:
            return self.docs_catalog.resolve().relative_to(ROOT).as_posix()
        except ValueError:
            return str(self.docs_catalog)

