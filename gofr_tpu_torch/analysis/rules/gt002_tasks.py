"""GT002 fire-and-forget tasks: spawned coroutines whose crash vanishes.

``asyncio.ensure_future`` / ``create_task`` detaches a coroutine from the
caller; if nobody awaits the task or attaches a done-callback, an escaped
exception is only whispered to the loop's exception handler at GC time —
a dead subscriber loop or cron job looks exactly like a quiet one.

The fix shipped with this rule is :func:`gofr_tpu_torch.aio.spawn_logged`,
which attaches a done-callback that logs the exception and increments
``app_async_task_failures_total{task=...}``.

Detection — for each ``ensure_future``/``create_task`` call site:

- result discarded (expression statement) → finding;
- result passed straight into another call (``list.append(...)``) →
  finding (stored, but still nothing observes the exception);
- result assigned to ``X`` → exempt only if the *same function* also has
  ``X.add_done_callback(...)`` or ``await X``; ``X.cancel()`` alone does
  not observe an exception raised before the cancel;
- ``await create_task(...)`` or ``return create_task(...)`` → exempt
  (the awaiter/caller observes the result);
- result handed to a class of the same module that keeps that argument
  as ``self.<attr>``, where the module awaits ``<x>.<attr>`` or takes
  ``<x>.<attr>.result()`` → exempt: the holder is the task's observer
  (the engine's ``_Fetch``, whose task the publish queue awaits in
  order). A holder whose attribute nobody awaits is still flagged.

The function-scope requirement is deliberate: "stop() awaits it later"
still loses every exception raised between start and stop, which for a
serve loop is the entire process lifetime.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

SPAWNERS = {"ensure_future", "create_task"}


def _spawn_label(module: ModuleInfo, call: ast.Call) -> Optional[str]:
    func = call.func
    dotted = module.dotted(func)
    if dotted in ("asyncio.ensure_future", "asyncio.create_task"):
        return dotted
    if isinstance(func, ast.Attribute) and func.attr in SPAWNERS:
        return func.attr
    return None


def _callee_name(call: ast.Call) -> str:
    if call.args and isinstance(call.args[0], ast.Call):
        inner = call.args[0].func
        if isinstance(inner, ast.Attribute):
            return inner.attr
        if isinstance(inner, ast.Name):
            return inner.id
    return "<coroutine>"


class FireAndForgetRule(Rule):
    rule_id = "GT002"
    title = "fire-and-forget-task"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            label = _spawn_label(module, node)
            if label is None:
                continue
            verdict = self._verdict(module, node)
            if verdict is None:
                continue
            fn = module.enclosing_function(node)
            where = fn.name if fn is not None else "<module>"
            findings.append(Finding(
                rule=self.rule_id,
                path=module.relpath,
                line=node.lineno,
                message=(
                    f"fire-and-forget task: {label}({_callee_name(node)}"
                    f"(...)) {verdict} — an escaped exception disappears "
                    f"silently; spawn with gofr_tpu_torch.aio.spawn_logged(...) "
                    f"or add_done_callback"),
                severity=self.severity,
                key=f"{label}({_callee_name(node)}) in {where}",
            ))
        return findings

    def _verdict(self, module: ModuleInfo,
                 call: ast.Call) -> Optional[str]:
        """None = exempt; else a short description of the leak."""
        parent = module.parents.get(call)
        if isinstance(parent, (ast.Await, ast.Return)):
            return None
        if isinstance(parent, ast.Expr):
            return "drops its result"
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = parent.targets[0]
            if self._observed(module, call, target):
                return None
            return (f"is assigned to "
                    f"'{ast.unparse(target)}' but never awaited and given "
                    f"no done-callback in this function")
        if isinstance(parent, ast.Call):
            if self._held_observed(module, parent, call):
                return None
            return "is passed along with no exception-handling callback"
        # starred/tuple/comprehension targets: be conservative, flag
        return "has no exception-handling done-callback"

    @staticmethod
    def _held_observed(module: ModuleInfo, holder: ast.Call,
                       call: ast.Call) -> bool:
        """Is ``call`` an argument of a class of this module that keeps it
        as an attribute the module awaits (or takes ``.result()`` of)?"""
        name = holder.func.id if isinstance(holder.func, ast.Name) else None
        if name is None or call not in holder.args:
            return False
        position = holder.args.index(call) + 1   # past ``self``
        for cls in module.tree.body:
            if not (isinstance(cls, ast.ClassDef) and cls.name == name):
                continue
            init = next((n for n in cls.body
                         if isinstance(n, ast.FunctionDef)
                         and n.name == "__init__"), None)
            if init is None or position >= len(init.args.args):
                return False
            param = init.args.args[position].arg
            attrs = {t.attr for n in ast.walk(init)
                     if isinstance(n, ast.Assign)
                     and isinstance(n.value, ast.Name)
                     and n.value.id == param
                     for t in n.targets if isinstance(t, ast.Attribute)}
            for node in ast.walk(module.tree):
                if isinstance(node, ast.Await):
                    inner = node.value
                    if isinstance(inner, ast.Call) and inner.args:
                        inner = inner.args[0]   # await asyncio.shield(x.t)
                    if isinstance(inner, ast.Attribute) and \
                            inner.attr in attrs:
                        return True
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "result" and \
                        isinstance(node.func.value, ast.Attribute) and \
                        node.func.value.attr in attrs:
                    return True
        return False

    def _observed(self, module: ModuleInfo, call: ast.Call,
                  target: ast.AST) -> bool:
        """True if the enclosing function awaits the target or attaches a
        done-callback to it."""
        fn = module.enclosing_function(call)
        scope = fn if fn is not None else module.tree
        target_src = ast.unparse(target)
        for node in ast.walk(scope):
            if isinstance(node, ast.Await) and \
                    ast.unparse(node.value) == target_src:
                return True
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "add_done_callback" and \
                    ast.unparse(node.func.value) == target_src:
                return True
        return False
