"""GT017 lock-held-across-await + slot-table mutation mid-iteration.

Two async-concurrency shapes that deadlock or corrupt serving state
without ever failing a CPU test:

**A. A *thread* lock held across ``await``.** ::

    with self._pool.lock:          # threading.RLock
        await self._fetch(...)     # loop suspends, lock stays held

The ``await`` parks this coroutine but the OS lock stays owned by the
loop thread. Any executor thread then blocking on ``pool.lock``
(exactly what the donating-dispatch closures do) stalls — and if the
awaited future needs that executor, the loop and the pool deadlock.
Flagged: a **sync** ``with`` over a lock-ish expression (dotted path
whose last segment contains ``lock``) whose body contains an ``await``,
inside an ``async def``. ``async with`` is exempt — asyncio locks are
designed to be held across suspension points.

**B. Slot-table mutation across ``await`` during iteration.** ::

    for sid, slot in self._slots.items():
        await self._drain(slot)        # other coroutines run here
        del self._slots[sid]           # RuntimeError: dict changed size

Every ``await`` inside the loop is a window where another coroutine
admits or evicts a slot; mutating the table you are iterating then
raises ``RuntimeError`` (dict) or silently skips slots (list). Flagged:
a ``for`` over a slot-table receiver (``_slots``/``slots``/
``_sessions``/``sessions``/``slot_table``, plain or via ``.items()``/
``.values()``/``.keys()``), whose body contains both an ``await`` and a
mutation of that same receiver (``del t[k]`` / ``t[k] = ...`` /
``t.pop(...)``-style calls). The sanctioned shape — snapshot with
``list(table.items())``, or collect doomed keys and mutate after the
loop — passes by construction.

Suppress deliberate cases with ``# graftcheck: ignore[GT017]`` plus a
justification.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from gofr_tpu_torch.analysis.dataflow import dotted_path
from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

_SLOT_TABLE_NAMES = {
    "_slots", "slots", "_sessions", "sessions", "slot_table",
    "_slot_table",
}
_VIEW_METHODS = {"items", "values", "keys"}
_MUTATING_CALLS = {
    "pop", "popitem", "clear", "remove", "discard", "append",
    "insert", "setdefault", "update", "add",
}


def _own_walk(node: ast.AST) -> Iterable[ast.AST]:
    """Descendants of ``node``, nested function/lambda bodies excluded
    (their awaits belong to another coroutine)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        yield from _own_walk(child)


def _is_lockish(path: Optional[str]) -> bool:
    if path is None:
        return False
    return "lock" in path.rsplit(".", 1)[-1].lower()


def _slot_table_path(iter_expr: ast.AST) -> Optional[str]:
    """``self._slots`` / ``self._slots.items()`` / ``slots.values()``
    → the table's dotted path when its last segment is slot-table
    named; ``list(...)`` snapshots return None (safe by construction)."""
    node = iter_expr
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _VIEW_METHODS:
            node = node.func.value
        else:
            return None  # list(...)/sorted(...)/tuple(...) snapshot
    path = dotted_path(node)
    if path is None:
        return None
    last = path.rsplit(".", 1)[-1]
    return path if last in _SLOT_TABLE_NAMES else None


def _enclosing_function(module: ModuleInfo, node: ast.AST):
    cursor = module.parents.get(node)
    while cursor is not None:
        if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cursor
        cursor = module.parents.get(cursor)
    return None


class LockAcrossAwaitRule(Rule):
    rule_id = "GT017"
    title = "lock-across-await"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        findings: List[Finding] = []
        findings.extend(self._sync_lock_across_await(module))
        findings.extend(self._slot_table_mutation(module))
        return findings

    # -- shape A: sync `with lock:` containing await -------------------------
    def _sync_lock_across_await(self, module: ModuleInfo
                                ) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.With):
                continue
            lock_path = None
            for item in node.items:
                path = dotted_path(item.context_expr)
                if _is_lockish(path):
                    lock_path = path
                    break
            if lock_path is None:
                continue
            awaits = [n for n in _own_walk(node)
                      if isinstance(n, ast.Await)]
            if not awaits:
                continue
            owner = _enclosing_function(module, node)
            if owner is None or not isinstance(owner,
                                               ast.AsyncFunctionDef):
                continue
            findings.append(Finding(
                rule=self.rule_id, path=module.relpath,
                line=node.lineno,
                message=(
                    f"lock-across-await: 'with {lock_path}:' in async "
                    f"'{owner.name}' holds a thread lock across "
                    f"'await' (line {awaits[0].lineno}) — the loop "
                    f"suspends but the OS lock stays held, stalling "
                    f"every executor thread that contends for it "
                    f"(deadlock if the awaited work needs that "
                    f"thread); release before awaiting, or use an "
                    f"asyncio lock with 'async with'"),
                severity=self.severity,
                key=f"with {lock_path} across await in {owner.name}",
            ))
        return findings

    # -- shape B: slot-table mutated across await during iteration -----------
    def _slot_table_mutation(self, module: ModuleInfo
                             ) -> Iterable[Finding]:
        findings: List[Finding] = []
        for loop in ast.walk(module.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor)):
                continue
            table = _slot_table_path(loop.iter)
            if table is None:
                continue
            body_nodes = []
            for stmt in loop.body:
                body_nodes.append(stmt)
                body_nodes.extend(_own_walk(stmt))
            awaits = [n for n in body_nodes if isinstance(n, ast.Await)]
            if not awaits:
                continue
            mutation = self._table_mutation(body_nodes, table)
            if mutation is None:
                continue
            owner = _enclosing_function(module, loop)
            owner_name = owner.name if owner is not None else "<module>"
            findings.append(Finding(
                rule=self.rule_id, path=module.relpath,
                line=mutation,
                message=(
                    f"slot-table-mutation-across-await: '{table}' is "
                    f"mutated at line {mutation} while being iterated "
                    f"(loop at line {loop.lineno}) with an 'await' in "
                    f"between (line {awaits[0].lineno}) — other "
                    f"coroutines admit/evict slots during the await, "
                    f"so this raises 'dict changed size during "
                    f"iteration' or skips slots; snapshot with "
                    f"'list({table}.items())' or collect keys and "
                    f"mutate after the loop"),
                severity=self.severity,
                key=f"slot-table mutation of {table} in {owner_name}",
            ))
        return findings

    @staticmethod
    def _table_mutation(body_nodes, table: str) -> Optional[int]:
        for node in body_nodes:
            if isinstance(node, ast.Delete):
                for target in node.targets:
                    if isinstance(target, ast.Subscript) \
                            and dotted_path(target.value) == table:
                        return node.lineno
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript) \
                            and dotted_path(target.value) == table:
                        return node.lineno
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATING_CALLS \
                    and dotted_path(node.func.value) == table:
                return node.lineno
        return None
