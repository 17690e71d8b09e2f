"""GT010 unbounded retry: broad except inside a forever loop, no escape.

The chaos plane makes retrying failures a first-class move —
and the classic way that move goes wrong is the blind retry loop::

    while True:
        try:
            await fetch()
        except Exception:
            continue          # spins hot forever against a dead peer

A persistent failure (peer gone, auth revoked, payload poisoned) turns
that loop into a busy-wait that hammers the dependency, pins a core,
and hides the outage from every caller. The repo's sanctioned shape is
``tpu/retry.py``'s :class:`RetryPolicy` — a bounded ``for`` over an
attempt budget with jittered backoff — which this rule cannot flag by
construction (no ``while True``).

Detection — for each ``while`` loop whose test is constantly true
(``while True:`` / ``while 1:``), every ``try`` in the loop's own body
with a *broad* handler (bare ``except``, ``except Exception``, or
``except BaseException``, alone or in a tuple) is a finding unless the
handler's own body (nested defs excluded) contains at least one of:

- an escape — ``raise``, ``return``, or ``break`` (the failure can
  leave the loop), *or a call to a helper whose body unconditionally
  raises* (an ``_abort(...)``-style escalator, resolved through the
  project call graph — even when it lives in another module), or
- pacing — a ``*.sleep(...)`` / ``*.wait(...)`` call (the retry is
  throttled, so a persistent failure degrades to a slow poll instead of
  a hot spin), *or a call to a helper that itself sleeps/waits* —
  followed through project call edges up to three hops, so a shared
  ``backoff()`` utility in its own module clears the loop. Pacing
  anywhere in the *loop's* own body clears the whole loop: a poll loop
  that sleeps between iterations cannot spin hot no matter which
  handler swallows (a ``continue`` can skip a trailing sleep, but that
  shape is rare enough to accept).

Loops whose test can go false (``while not self._draining``) terminate
by state and are skipped, as are ``try`` statements *wrapping* the loop
(a caught failure there exits the loop, it does not retry) and ``try``
statements nested *inside* another handler (error-path cleanup — the
swallow guards recovery code, not the retried operation). Narrow
handlers (``except KVWireError``) are deliberate routing, not blind
swallowing, and pass.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

_BROAD = {"Exception", "BaseException"}
_PACED_CALLS = {"sleep", "wait"}


def _constant_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _own_walk(node: ast.AST) -> Iterable[ast.AST]:
    """Walk ``node`` skipping nested function/lambda bodies — their
    control flow belongs to the nested callable, not this loop."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _own_walk(child)


def _is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for node in types:
        name = node.id if isinstance(node, ast.Name) else (
            node.attr if isinstance(node, ast.Attribute) else None)
        if name in _BROAD:
            return True
    return False


def _escapes(handler: ast.ExceptHandler) -> bool:
    for node in _own_walk(handler):
        if isinstance(node, (ast.Raise, ast.Return, ast.Break)):
            return True
    return False


def _paced(scope: ast.AST) -> bool:
    """True when ``scope``'s own walk contains a sleep/wait call."""
    for node in _own_walk(scope):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if name in _PACED_CALLS:
            return True
    return False


def _always_raises(fn_node: ast.AST) -> bool:
    """A function whose body cannot fall through: every statement is a
    docstring/logging ``Expr`` except the final ``Raise``. Calling one
    from a handler is as good as raising inline."""
    body = getattr(fn_node, "body", [])
    if not body or not isinstance(body[-1], ast.Raise):
        return False
    return all(isinstance(stmt, ast.Expr) for stmt in body[:-1])


class _CallResolver:
    """Follows project call edges from a scope's call sites: is any
    callee (transitively, ≤3 hops) paced? does any callee always
    raise? Works with local-only edges when cross_module is off."""

    def __init__(self, project, ref):
        self.project = project
        self._by_site = {}
        if ref is not None:
            for callee, site in project.calls(ref):
                self._by_site.setdefault(id(site), callee)

    def callees_in(self, scope: ast.AST):
        for node in _own_walk(scope):
            if isinstance(node, ast.Call):
                callee = self._by_site.get(id(node))
                if callee is not None:
                    yield callee

    def paced_through(self, scope: ast.AST) -> bool:
        seen = set()
        stack = list(self.callees_in(scope))
        depth = {ref: 1 for ref in stack}
        while stack:
            ref = stack.pop()
            if ref in seen:
                continue
            seen.add(ref)
            fn = self.project.functions.get(ref)
            if fn is None:
                continue
            for node in self.project.body_nodes(ref):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                name = func.attr if isinstance(func, ast.Attribute) \
                    else (func.id if isinstance(func, ast.Name) else None)
                if name in _PACED_CALLS:
                    return True
            if depth.get(ref, 1) < 3:
                for callee, _site in self.project.calls(ref):
                    if callee not in seen:
                        depth[callee] = depth.get(ref, 1) + 1
                        stack.append(callee)
        return False

    def escapes_through(self, handler: ast.ExceptHandler) -> bool:
        for ref in self.callees_in(handler):
            fn = self.project.functions.get(ref)
            if fn is not None and _always_raises(fn.node):
                return True
        return False


def _in_handler(module: ModuleInfo, node: ast.AST,
                loop: ast.While) -> bool:
    """True when ``node`` sits inside an except handler between itself
    and ``loop`` — error-path cleanup, not the retried operation."""
    cursor = module.parents.get(node)
    while cursor is not None and cursor is not loop:
        if isinstance(cursor, ast.ExceptHandler):
            return True
        cursor = module.parents.get(cursor)
    return False


def _loop_owner(module: ModuleInfo, loop: ast.While) -> str:
    node = loop
    while node in module.parents:
        node = module.parents[node]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node.name
    return "<module>"


def _owner_node(module: ModuleInfo, loop: ast.While):
    node = loop
    while node in module.parents:
        node = module.parents[node]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node
    return None


class UnboundedRetryRule(Rule):
    rule_id = "GT010"
    title = "unbounded-retry"
    severity = "error"

    def check_project(self, project) -> Iterable[Finding]:
        findings: List[Finding] = []
        for rel in sorted(project.modules):
            findings.extend(
                self._check_module(project.modules[rel], project))
        return findings

    def _check_module(self, module: ModuleInfo,
                      project) -> Iterable[Finding]:
        findings: List[Finding] = []
        for loop in ast.walk(module.tree):
            if not isinstance(loop, ast.While) or \
                    not _constant_true(loop.test):
                continue
            owner_node = _owner_node(module, loop)
            ref = (project.ref_of_node(owner_node)
                   if owner_node is not None else None)
            resolver = _CallResolver(project, ref)
            if _paced(loop) or resolver.paced_through(loop):
                continue
            for node in _own_walk(loop):
                if not isinstance(node, ast.Try):
                    continue
                if _in_handler(module, node, loop):
                    continue
                for handler in node.handlers:
                    if not _is_broad(handler):
                        continue
                    if _escapes(handler) or \
                            resolver.escapes_through(handler):
                        continue
                    owner = _loop_owner(module, loop)
                    findings.append(Finding(
                        rule=self.rule_id,
                        path=module.relpath,
                        line=handler.lineno,
                        message=(
                            f"broad except inside '{owner}'s "
                            f"while-True loop swallows every failure "
                            f"and retries immediately — a persistent "
                            f"failure spins hot forever; bound the "
                            f"attempts (tpu/retry.py RetryPolicy), "
                            f"back off before retrying, or re-raise"),
                        severity=self.severity,
                        key=f"unbounded retry in {owner}",
                    ))
        return findings
