"""GT012: workload capture must stay shape-only — no request content.

The workload plane's whole contract is that a traffic trace
is safe to export, check into a bench artifact, and ship between
machines BECAUSE it contains only the workload's *shape*: token counts,
timings, class labels. One convenient ``event["prompt"] = prompt`` and
the trace silently becomes a user-data store — a privacy and retention
problem no amount of histogramming fixes after the fact. This rule is
the static guard on that invariant.

Scope: modules whose filename stem contains ``workload`` or that live
under a ``workload/`` directory (the recorder, the workloadz endpoint,
anything the plane grows later). ``scope_all=True`` widens to every
module (fixture tests).

What it flags — a *content-named* identifier (``prompt``, ``tokens``,
``token_ids``, ``text``, ``body``, ``payload``, ``completion``, …)
reaching a store:

1. anywhere in scope, into persistent state: ``self.X = value``,
   ``self.X[...] = value``, or a grow call (``self.X.append(...)``,
   ``.extend``/``.insert``/``.add``/``.setdefault``/``.appendleft``) —
   plus module-level names, which live as long as the process;
2. inside an export-shaped function (name matching ``export`` /
   ``snapshot`` / ``serialize`` / ``to_dict`` / ``to_json`` / ``dump``),
   into ANY target — including locals and ``return`` values, because an
   export function's locals *are* the serialized artifact.

Also flagged: a content-named **string key** in a dict literal or
subscript store at those sites (``{"prompt": p}``, ``row["text"] = v``)
— renaming the local does not launder the content.

What clears it: wrapping the content in a sanctioned shape-extractor —
``len()`` / ``min()`` / ``max()`` / ``sum()`` / ``bool()`` / ``int()`` /
``float()`` / ``hash()``. ``len(prompt)`` is a length; ``prompt`` is the
user's data. The scan does not descend into sanctioned calls, so
``event.prompt_len = len(prompt)`` is clean by construction.

Suppress a deliberate exception with ``# graftcheck: ignore[GT012]`` on
the offending line.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Set, Tuple

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

_SCOPE_DIRS = {"workload"}
_SCOPE_STEM = "workload"
_EXPORT_NAME = re.compile(
    r"(export|snapshot|serialize|to_dict|to_json|dump)")
_CONTENT_NAMES = {
    "prompt", "prompts", "prompt_ids", "prompt_tokens", "prompt_text",
    "tokens", "token_ids", "output_ids", "input_ids",
    "text", "texts", "body", "request_body", "content", "contents",
    "message", "messages", "raw", "payload", "completion", "completions",
}
# shape extractors: the value that leaves these is a number, not content
_SANCTIONED = {"len", "min", "max", "sum", "bool", "int", "float", "hash"}
_GROW_CALLS = {"append", "appendleft", "extend", "insert", "add",
               "setdefault"}


def _in_scope(relpath: str) -> bool:
    parts = relpath.split("/")
    if _SCOPE_DIRS & set(parts[:-1]):
        return True
    return _SCOPE_STEM in parts[-1].rsplit(".", 1)[0]


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _content_refs(value: ast.AST) -> List[Tuple[str, int]]:
    """Content-named terminal identifiers reachable in ``value`` without
    passing through a sanctioned shape-extractor call. Matches bare
    names, attribute tails, content-named string subscript keys, and
    content-named dict-literal keys."""
    refs: List[Tuple[str, int]] = []
    stack: List[ast.AST] = [value]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            if _call_name(node) in _SANCTIONED:
                continue          # len(prompt) et al: shape, not content
            stack.extend(ast.iter_child_nodes(node))
            continue
        if isinstance(node, ast.Name):
            if node.id in _CONTENT_NAMES:
                refs.append((node.id, node.lineno))
            continue
        if isinstance(node, ast.Attribute):
            if node.attr in _CONTENT_NAMES:
                refs.append((node.attr, node.lineno))
            else:
                stack.append(node.value)
            continue
        if isinstance(node, ast.Dict):
            for key in node.keys:
                if isinstance(key, ast.Constant) and \
                        isinstance(key.value, str) and \
                        key.value in _CONTENT_NAMES:
                    refs.append((key.value, key.lineno))
            stack.extend(v for v in node.values if v is not None)
            continue
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str) and \
                    node.slice.value in _CONTENT_NAMES:
                refs.append((node.slice.value, node.lineno))
            stack.append(node.value)
            continue
        stack.extend(ast.iter_child_nodes(node))
    return refs


def _key_tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def _owner_function(module: ModuleInfo,
                    node: ast.AST) -> Optional[ast.AST]:
    cursor = module.parents.get(node)
    while cursor is not None:
        if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cursor
        cursor = module.parents.get(cursor)
    return None


class WorkloadContentLeakRule(Rule):
    rule_id = "GT012"
    title = "workload-content-leak"
    severity = "error"

    def __init__(self, scope_all: bool = False):
        self.scope_all = bool(scope_all)

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        if not self.scope_all and not _in_scope(module.relpath):
            return []
        seen: Set[Tuple[str, int]] = set()
        findings: List[Finding] = []

        def flag(value: ast.AST, where: str) -> None:
            for name, line in _content_refs(value):
                if (name, line) in seen:
                    continue
                seen.add((name, line))
                findings.append(Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=line,
                    message=(
                        f"'{name}' reaches {where} — the workload plane "
                        f"is shape-only: store len()/counts/labels, "
                        f"never token ids, prompt strings, or request "
                        f"bodies (a trace must stay safe to export)"),
                    severity=self.severity,
                    key=f"workload content leak '{name}'",
                ))

        for node in ast.walk(module.tree):
            fn = _owner_function(module, node)
            exporting = fn is not None and bool(
                _EXPORT_NAME.search(fn.name))

            # persistent stores: self.X / module-level targets,
            # anywhere in scope; export functions: ANY target — the
            # locals there become the serialized artifact
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                if value is None:
                    continue
                for target in targets:
                    base = (target.value
                            if isinstance(target, ast.Subscript)
                            else target)
                    persistent = _is_self_attr(base) or (
                        isinstance(base, ast.Name) and fn is None)
                    if persistent or exporting:
                        where = (f"persistent store "
                                 f"'{_key_tail(base)}'" if persistent
                                 else f"export path '{fn.name}'")
                        flag(value, where)
                        if isinstance(target, ast.Subscript):
                            flag(target, where)
                        break
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _GROW_CALLS:
                receiver = node.func.value
                persistent = _is_self_attr(receiver)
                if persistent or exporting:
                    where = (f"persistent store "
                             f"'{_key_tail(receiver)}'" if persistent
                             else f"export path '{fn.name}'")
                    for arg in [*node.args,
                                *[kw.value for kw in node.keywords]]:
                        flag(arg, where)
            elif exporting and isinstance(node, ast.Return) and \
                    node.value is not None:
                flag(node.value, f"export path '{fn.name}' return value")

        findings.sort(key=lambda f: f.line)
        return findings
