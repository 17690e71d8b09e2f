"""GT009 cron re-entrancy: overlapping firings of an awaiting handler.

The cron plane (``gofr_tpu_torch/cron.py``) spawns **every** due firing as its
own task — deliberately, so one wedged job cannot stall the tick loop.
The flip side: a handler that awaits unbounded work (probe sweeps, scale
operations, drains) can overlap itself once its wall time crosses the
cron period, and overlapping instances of a control job compound —
two autoscaler steps acting on the same stale signals double-scale, two
drain sweeps migrate the same sessions.

The fix is the single-flight shape the fleet autoscaler ships::

    async def handler(ctx):
        if self._busy:          # overlap guard: drop, don't queue
            return
        self._busy = True
        try:
            await do_the_work()
        finally:
            self._busy = False

Detection — for each ``add_cron_job(spec, name, func)`` registration
(also ``*.add_job(...)`` on a receiver whose name mentions ``cron``)
whose handler resolves to an ``async def`` in the same module:

- the handler's own body (nested defs excluded) contains an ``await``,
  and
- no top-level ``if`` statement that can ``return``/``raise`` appears
  before the first ``await``

→ finding, anchored at the handler definition. Handlers registered as
bound methods, callable instances, or lambdas are not resolvable
statically and are skipped (be accurate, not noisy); handlers with no
``await`` are bounded by construction.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule


def _is_cron_registration(module: ModuleInfo,
                          call: ast.Call) -> bool:
    func = call.func
    attr = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    if attr == "add_cron_job":
        return True
    if attr == "add_job" and isinstance(func, ast.Attribute):
        # Crontab.add_job — only when the receiver is recognizably the
        # cron plane, so scheduler libraries with an add_job of their
        # own don't trip the rule
        return "cron" in ast.unparse(func.value).lower()
    return False


def _handler_name(call: ast.Call) -> Optional[str]:
    """The registered handler, when it is a plain name: third positional
    arg (``add_cron_job(spec, name, func)``) or the ``func`` keyword."""
    node: Optional[ast.AST] = None
    if len(call.args) >= 3:
        node = call.args[2]
    for kw in call.keywords:
        if kw.arg == "func":
            node = kw.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _own_awaits(fn: ast.AsyncFunctionDef) -> List[ast.Await]:
    """Await nodes in ``fn``'s own body, nested function defs excluded."""
    out: List[ast.Await] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Await):
                out.append(child)
            visit(child)

    visit(fn)
    return out


def _bails_out(stmt: ast.If) -> bool:
    """True when the If can short-circuit the handler: its body reaches a
    ``return`` or ``raise`` (the overlap-guard shape)."""
    for node in ast.walk(stmt):
        if isinstance(node, (ast.Return, ast.Raise)):
            return True
    return False


def _has_overlap_guard(fn: ast.AsyncFunctionDef,
                       first_await_line: int) -> bool:
    """A guard is a top-level bail-out ``if`` strictly before the first
    await — the only placement that stops a second firing from entering
    the awaited region."""
    for stmt in fn.body:
        if stmt.lineno >= first_await_line:
            break
        if isinstance(stmt, ast.If) and _bails_out(stmt):
            return True
    return False


class CronReentrancyRule(Rule):
    rule_id = "GT009"
    title = "cron-reentrancy"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        handlers: Dict[str, List[ast.AsyncFunctionDef]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                handlers.setdefault(node.name, []).append(node)

        findings: List[Finding] = []
        seen = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or \
                    not _is_cron_registration(module, node):
                continue
            name = _handler_name(node)
            if name is None:
                continue
            for fn in handlers.get(name, ()):
                if id(fn) in seen:
                    continue
                seen.add(id(fn))
                awaits = _own_awaits(fn)
                if not awaits:
                    continue
                first_line = min(a.lineno for a in awaits)
                if _has_overlap_guard(fn, first_line):
                    continue
                findings.append(Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=fn.lineno,
                    message=(
                        f"cron handler '{name}' awaits unbounded work "
                        f"with no overlap guard — cron spawns every "
                        f"firing as its own task, so a slow step "
                        f"overlaps itself; make it single-flight "
                        f"(guard + early return before the first "
                        f"await) or bound the awaited work"),
                    severity=self.severity,
                    key=f"cron handler {name}",
                ))
        return findings
