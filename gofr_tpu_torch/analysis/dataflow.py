"""Lightweight intraprocedural value flow for graftcheck rules.

Rules need "does value X reach sink Y" questions a call graph cannot
answer: GT015 asks whether an array passed through a ``donate_argnums``
position is *read again* after the dispatching call; GT016 asks whether
a name is an alias of a pool. :class:`ValueFlow` gives each function a
cheap, statement-ordered fact base:

- every **assignment** (plain, tuple/list unpack, augmented, annotated,
  ``for`` targets, ``with ... as``) as a *kill* of its target's dotted
  path, with the assigned value expression kept for rule-side
  propagation (GT015 walks them to find ``jax.jit(..., donate_argnums)``
  results flowing through locals and attribute tables);
- every **load** of a Name/Attribute chain, by dotted path;
- every **return** value expression.

Facts carry a monotonically increasing *statement index* in source
order, so "after the call" and "killed in between" are integer
comparisons. The pass is path-insensitive on purpose: a kill inside one
``if`` arm shadows a use in the other arm (a rare false negative, noted
in the docs) — but it never *invents* a kill, so "flagged" always means
"there is a textual read after the donating call with no rebind before
it". Nested ``def``/``lambda`` bodies are excluded exactly like the
call graph's ``body_nodes``: a closure is its own function with its own
flow.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["ValueFlow", "dotted_path"]


def dotted_path(node: ast.AST) -> Optional[str]:
    """``self._pool.leaves`` → ``"self._pool.leaves"``; None for
    expressions not rooted at a plain Name (calls, subscripts...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


class _Fact:
    __slots__ = ("stmt", "lineno", "path", "node", "value")

    def __init__(self, stmt: int, lineno: int, path: str,
                 node: ast.AST, value: Optional[ast.AST] = None):
        self.stmt = stmt          # statement index, source order
        self.lineno = lineno
        self.path = path          # dotted path of the name/attr chain
        self.node = node
        self.value = value        # assigned expression (kills only)


class ValueFlow:
    """Statement-ordered loads/kills/returns for one function body."""

    def __init__(self, fn_node: ast.AST):
        self.fn_node = fn_node
        self.kills: List[_Fact] = []
        self.loads: List[_Fact] = []
        self.returns: List[Tuple[int, Optional[ast.AST]]] = []
        self.assigns_in_order: List[_Fact] = []   # kills with values
        self._stmt_of: Dict[int, int] = {}        # id(node) -> stmt idx
        self._counter = 0
        for stmt in fn_node.body:
            self._walk_stmt(stmt)

    # -- collection ---------------------------------------------------------
    def _next(self) -> int:
        self._counter += 1
        return self._counter

    def _walk_stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        idx = self._next()
        self._index_expr_nodes(stmt, idx)
        if isinstance(stmt, ast.Assign):
            self._loads_in(stmt.value, idx)
            for target in stmt.targets:
                self._kill_target(target, idx, stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            # an augmented assign reads the old value, then rebinds
            self._loads_in(stmt.value, idx)
            path = dotted_path(stmt.target)
            if path is not None:
                self.loads.append(
                    _Fact(idx, stmt.lineno, path, stmt.target))
                self._add_kill(idx, stmt.lineno, path, stmt.target, None)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._loads_in(stmt.value, idx)
                self._kill_target(stmt.target, idx, stmt.value)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._loads_in(stmt.value, idx)
            self.returns.append((idx, stmt.value))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._loads_in(stmt.iter, idx)
            self._kill_target(stmt.target, idx, None)
            for child in stmt.body + stmt.orelse:
                self._walk_stmt(child)
        elif isinstance(stmt, ast.While):
            self._loads_in(stmt.test, idx)
            for child in stmt.body + stmt.orelse:
                self._walk_stmt(child)
        elif isinstance(stmt, ast.If):
            self._loads_in(stmt.test, idx)
            for child in stmt.body + stmt.orelse:
                self._walk_stmt(child)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._loads_in(item.context_expr, idx)
                if item.optional_vars is not None:
                    self._kill_target(item.optional_vars, idx, None)
            for child in stmt.body:
                self._walk_stmt(child)
        elif isinstance(stmt, ast.Try):
            for child in (stmt.body + stmt.orelse + stmt.finalbody):
                self._walk_stmt(child)
            for handler in stmt.handlers:
                for child in handler.body:
                    self._walk_stmt(child)
        elif isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                path = dotted_path(target)
                if path is not None:
                    self._add_kill(idx, stmt.lineno, path, target, None)
        else:
            self._loads_in(stmt, idx)

    def _kill_target(self, target: ast.AST, idx: int,
                     value: Optional[ast.AST]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._kill_target(elt, idx, None)
            return
        if isinstance(target, ast.Starred):
            self._kill_target(target.value, idx, None)
            return
        if isinstance(target, ast.Subscript):
            # ``table[k] = v`` mutates, it does not rebind: the
            # container path is loaded, not killed
            self._loads_in(target, idx)
            return
        path = dotted_path(target)
        if path is not None:
            self._add_kill(idx, target.lineno, path, target, value)
            # assigning ``self.x = ...`` loads ``self`` but that load
            # is structural; skip recording loads for bare targets

    def _add_kill(self, idx: int, lineno: int, path: str,
                  node: ast.AST, value: Optional[ast.AST]) -> None:
        fact = _Fact(idx, lineno, path, node, value)
        self.kills.append(fact)
        self.assigns_in_order.append(fact)

    def _loads_in(self, expr: ast.AST, idx: int) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                continue
            if isinstance(node, (ast.Name, ast.Attribute)) \
                    and isinstance(getattr(node, "ctx", None), ast.Load):
                path = dotted_path(node)
                if path is not None:
                    self.loads.append(
                        _Fact(idx, node.lineno, path, node))

    def _index_expr_nodes(self, stmt: ast.AST, idx: int) -> None:
        for node in ast.walk(stmt):
            self._stmt_of.setdefault(id(node), idx)

    # -- queries ------------------------------------------------------------
    def stmt_index(self, node: ast.AST) -> Optional[int]:
        return self._stmt_of.get(id(node))

    def killed_between(self, path: str, start: int, end: int) -> bool:
        """A rebind of ``path`` (or a prefix rebind: ``x = ...`` kills
        ``x.attr``) with start <= stmt <= end."""
        for kill in self.kills:
            if start <= kill.stmt <= end and _covers(kill.path, path):
                return True
        return False

    def loads_after(self, path: str, stmt: int
                    ) -> List[Tuple[int, ast.AST]]:
        """Loads of ``path`` or an extension of it (a load of
        ``x.attr`` counts as a read of donated ``x``; a load of the
        *prefix* ``x`` does not count for donated ``x.attr`` — reading
        the pool object is not reading its donated leaves) strictly
        after ``stmt``, not preceded by a rebind at or after ``stmt``."""
        out: List[Tuple[int, ast.AST]] = []
        for load in self.loads:
            if load.stmt <= stmt:
                continue
            if not _covers(path, load.path):
                continue
            if self.killed_between(path, stmt, load.stmt):
                break
            out.append((load.lineno, load.node))
        return out

    def aliases_at(self, path: str, stmt: int) -> List[str]:
        """One-hop copy aliases live at ``stmt``: names assigned
        *from* ``path`` before ``stmt`` and not since rebound."""
        out: List[str] = []
        for kill in self.assigns_in_order:
            if kill.stmt >= stmt or kill.value is None:
                continue
            value_path = dotted_path(kill.value)
            if value_path != path:
                continue
            if not self.killed_between(kill.path, kill.stmt + 1, stmt):
                out.append(kill.path)
        return out

    def kills_inside(self, path: str, container: ast.AST) -> bool:
        """Any rebind of ``path`` whose node sits inside ``container``
        (loop-carried donation check: no kill inside the loop body means
        the donated handle is re-read on the next iteration)."""
        inside = {id(n) for n in ast.walk(container)}
        return any(id(kill.node) in inside
                   for kill in self.kills if _covers(kill.path, path))


def _covers(killer: str, victim: str) -> bool:
    """``x`` kills ``x`` and ``x.attr``; ``x.a`` kills ``x.a.b`` but
    not ``x`` itself."""
    return victim == killer or victim.startswith(killer + ".")


def iter_calls(fn_body_nodes: Iterable[ast.AST]) -> Iterable[ast.Call]:
    for node in fn_body_nodes:
        if isinstance(node, ast.Call):
            yield node
