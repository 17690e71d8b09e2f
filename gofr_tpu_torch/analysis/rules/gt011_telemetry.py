"""GT011 unbounded telemetry buffer: recording paths that only grow.

The telemetry plane lives *inside* the serving process, so
every buffer it keeps is HBM-adjacent host memory that the decode loop
pays for. The classic leak shape is an innocent recorder::

    class Recorder:
        def __init__(self):
            self.samples = []

        def record(self, value):
            self.samples.append(value)     # grows for process lifetime

Every sample, span, or anomaly recorded on a hot path accretes forever;
after a week of serving the "observability" plane is the biggest tenant
in the process. The repo's sanctioned shapes are bounded by
construction: ``deque(maxlen=...)`` rings (``SeriesRing``, the tick
anatomy ring, the delta log), an explicit trim (``del events[:-64]``),
or a capacity check (``if len(self.events) < self.MAX_EVENTS``).

Detection — scoped to telemetry modules (any path under a ``metrics``
or ``trace`` package, or whose stem mentions ``telemetry`` /
``timeseries`` / ``timez`` / ``tracer``; ``scope_all=True`` widens to
every module, used by the fixture tests). Within scope:

1. *Candidates* — names initialized as plain growable containers
   (``X = []`` / ``X = {}`` / ``list()`` / ``dict()``, plain or
   annotated), either module-level or ``self.X`` attributes.
2. *Growth sites* — ``.append`` / ``.extend`` / ``.insert`` /
   ``.setdefault`` calls or subscript assignment on a candidate, but
   only inside functions whose name reads like a recording hot path
   (``record``, ``observe``, ``add``, ``note``, ``sample``,
   ``ingest``, ``track``, ``push``, ``emit``, ``publish``, ``on_*``,
   ``handle``, ``fire``, ``mark``) or any ``async def`` — one-shot
   setup code may build unbounded structure; per-event code may not.
3. *Bound evidence* — anywhere in the module, matched by name so a
   helper may own the trim: a ``deque(...)`` (re)initialization, a
   consuming call (``.pop`` / ``.popleft`` / ``.popitem`` /
   ``.clear``), a ``del X[...]`` / slice assignment trim, or ``len(X)``
   used inside a comparison (a capacity gate).

A candidate with a hot growth site and no bound evidence is a finding.
Matching is by attribute *name* regardless of receiver, so a structure
grown via a local alias (``metric.series[key] = ...``) is cleared by a
cardinality gate elsewhere (``if len(metric.series) == WARN``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

_SCOPE_DIRS = {"metrics", "trace"}
_SCOPE_STEMS = ("telemetry", "timeseries", "timez", "tracer", "workload",
                "diagnose")
_HOT_NAME = re.compile(
    r"(record|observe|add|note|sample|ingest|track|append|push|emit"
    r"|publish|on_|handle|fire|mark)")
_GROW_CALLS = {"append", "extend", "insert", "setdefault"}
_DRAIN_CALLS = {"pop", "popleft", "popitem", "clear"}


def _in_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    if _SCOPE_DIRS & set(parts[:-1]):
        return True
    stem = parts[-1].rsplit(".", 1)[0]
    return any(marker in stem for marker in _SCOPE_STEMS)


def _key_of(node: ast.AST) -> Optional[str]:
    """The tracked name for a receiver/target: ``self.X`` / ``obj.X``
    → ``X``, a bare ``Name`` → its id."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_plain_growable(value: ast.AST) -> bool:
    if isinstance(value, ast.List) and not value.elts:
        return True
    if isinstance(value, ast.Dict) and not value.keys:
        return True
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
            and value.func.id in ("list", "dict") and not value.args:
        return True
    return False


def _is_deque_init(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = _key_of(value.func)
    return name == "deque"


def _candidate_target(target: ast.AST) -> Optional[str]:
    """A module-level name or a ``self.X`` attribute; anything else
    (locals, arbitrary receivers) is not a lifetime container."""
    if isinstance(target, ast.Name):
        return target.id
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and \
            target.value.id == "self":
        return target.attr
    return None


def _assign_pairs(node: ast.AST) -> Iterable[Tuple[ast.AST, ast.AST]]:
    if isinstance(node, ast.Assign):
        for target in node.targets:
            yield target, node.value
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        yield node.target, node.value


def _owner_function(module: ModuleInfo,
                    node: ast.AST) -> Optional[ast.AST]:
    cursor = module.parents.get(node)
    while cursor is not None:
        if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cursor
        cursor = module.parents.get(cursor)
    return None


def _is_hot(fn: Optional[ast.AST]) -> bool:
    if fn is None:
        return False
    if isinstance(fn, ast.AsyncFunctionDef):
        return True
    return bool(_HOT_NAME.search(fn.name))


class UnboundedTelemetryBufferRule(Rule):
    rule_id = "GT011"
    title = "unbounded-telemetry-buffer"
    severity = "error"

    def __init__(self, scope_all: bool = False):
        self.scope_all = bool(scope_all)

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        if not self.scope_all and not _in_scope(module.relpath):
            return []
        candidates: Dict[str, int] = {}
        bounded: Set[str] = set()
        growth: Dict[str, Tuple[int, str]] = {}

        for node in ast.walk(module.tree):
            # 1. candidate inits + deque-init bound evidence. A bare
            #    Name only counts at module level — a function-local
            #    list dies with the call and cannot accrete.
            for target, value in _assign_pairs(node):
                key = _candidate_target(target)
                if key is None:
                    continue
                if isinstance(target, ast.Name) and \
                        _owner_function(module, node) is not None:
                    continue
                if _is_deque_init(value):
                    bounded.add(key)
                elif _is_plain_growable(value):
                    candidates.setdefault(key, node.lineno)
            # 3. bound evidence: consuming calls, del/slice trims,
            #    len() capacity gates
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _DRAIN_CALLS:
                key = _key_of(node.func.value)
                if key is not None:
                    bounded.add(key)
            if isinstance(node, ast.Delete):
                for target in node.targets:
                    if isinstance(target, ast.Subscript):
                        key = _key_of(target.value)
                        if key is not None:
                            bounded.add(key)
            if isinstance(node, ast.Compare):
                for side in [node.left, *node.comparators]:
                    if isinstance(side, ast.Call) and \
                            isinstance(side.func, ast.Name) and \
                            side.func.id == "len" and side.args:
                        key = _key_of(side.args[0])
                        if key is not None:
                            bounded.add(key)

        # 2. growth sites inside recording hot paths
        for node in ast.walk(module.tree):
            key: Optional[str] = None
            line = 0
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _GROW_CALLS:
                key = _key_of(node.func.value)
                line = node.lineno
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript):
                        if isinstance(target.slice, ast.Slice):
                            trim = _key_of(target.value)
                            if trim is not None:   # X[:] = ... is a trim
                                bounded.add(trim)
                            continue
                        key = _key_of(target.value)
                        line = node.lineno
            if key is None or key not in candidates:
                continue
            fn = _owner_function(module, node)
            if not _is_hot(fn):
                continue
            if key not in growth:
                growth[key] = (line, fn.name)

        findings: List[Finding] = []
        for key, (line, fn_name) in sorted(growth.items(),
                                           key=lambda kv: kv[1][0]):
            if key in bounded:
                continue
            findings.append(Finding(
                rule=self.rule_id,
                path=module.relpath,
                line=line,
                message=(
                    f"'{key}' is a plain container grown in recording "
                    f"path '{fn_name}' with no bound in sight — an "
                    f"in-process telemetry buffer accretes for the "
                    f"process lifetime; use deque(maxlen=...), trim "
                    f"with del {key}[:-N], or gate on len({key})"),
                severity=self.severity,
                key=f"unbounded telemetry buffer '{key}'",
            ))
        return findings
