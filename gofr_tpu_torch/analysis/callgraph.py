"""Module-local call graph: which functions run *on the asyncio loop*.

GT001 needs "is this blocking call reachable from an ``async def``
without a thread hop?". The graph is deliberately module-local — cheap,
predictable, and conservative in the right direction: an edge only
exists when the callee is a plain call we can resolve (``foo(...)``,
``self.bar(...)``, ``cls.baz(...)``). Callables that are *passed* to
``run_in_executor`` / ``asyncio.to_thread`` / thread constructors appear
as arguments, not calls, so the thread hop falls out of the graph for
free — exactly the hand-offload idiom the serving stack uses
(``gofr_tpu_torch/tpu/generate.py`` dispatch/fetch, batcher cold path).

Loop-scheduled callbacks are still loop context: ``loop.call_soon(fn)``,
``loop.call_later(delay, fn)`` and ``task.add_done_callback(fn)`` run
their target on the loop, so they contribute edges too.

Lambdas are treated as part of their enclosing function: the dominant
idiom here is immediate invocation (``jax.tree.map(lambda ...)``,
``sorted(key=...)``), and missing a blocking call inside one would be a
false negative on the hot path.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from gofr_tpu_torch.analysis.engine import ModuleInfo

# callback argument positions that execute on the event loop
_LOOP_CALLBACK_ARG = {
    "call_soon": 0,
    "call_soon_threadsafe": 0,
    "call_later": 1,
    "call_at": 1,
    "add_done_callback": 0,
}


class FunctionNode:
    __slots__ = ("qualname", "node", "is_async", "calls", "class_name")

    def __init__(self, qualname: str, node: ast.AST, is_async: bool,
                 class_name: Optional[str]):
        self.qualname = qualname
        self.node = node
        self.is_async = is_async
        self.class_name = class_name
        self.calls: List[Tuple[str, ast.Call]] = []  # (callee key, site)


class CallGraph:
    """Functions of one module + resolvable call edges between them."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.functions: Dict[str, FunctionNode] = {}
        self._collect(module.tree, prefix="", class_name=None)
        for node in self.functions.values():
            self._edges(node)

    # -- collection ---------------------------------------------------------
    def _collect(self, tree: ast.AST, prefix: str,
                 class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(tree):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                self.functions[qual] = FunctionNode(
                    qual, child,
                    isinstance(child, ast.AsyncFunctionDef), class_name)
                self._collect(child, prefix=f"{qual}.<locals>.",
                              class_name=class_name)
            elif isinstance(child, ast.ClassDef):
                self._collect(child, prefix=f"{child.name}.",
                              class_name=child.name)
            else:
                self._collect(child, prefix=prefix, class_name=class_name)

    # -- body iteration: a function's own statements, lambdas inlined ------
    def body_nodes(self, fn: FunctionNode):
        """Yield every AST node executed *as part of* this function:
        descends into lambdas and comprehensions but not into nested
        ``def``s (those are separate graph nodes, only live if called)."""
        stack: List[ast.AST] = list(ast.iter_child_nodes(fn.node))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # -- edges --------------------------------------------------------------
    def _resolve(self, fn: FunctionNode, call: ast.Call) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Name):
            # nearest scope first: a sibling nested def, then module level
            local = f"{fn.qualname}.<locals>.{func.id}"
            if local in self.functions:
                return local
            if func.id in self.functions:
                return func.id
        elif isinstance(func, ast.Attribute) and \
                isinstance(func.value, ast.Name):
            if func.value.id in ("self", "cls") and fn.class_name:
                method = f"{fn.class_name}.{func.attr}"
                if method in self.functions:
                    return method
        return None

    def _callback_target(self, fn: FunctionNode,
                         call: ast.Call) -> Optional[str]:
        """Resolve loop-scheduled callbacks: call_soon/call_later/
        add_done_callback targets run on the loop."""
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        index = _LOOP_CALLBACK_ARG.get(func.attr)
        if index is None or len(call.args) <= index:
            return None
        target = call.args[index]
        if isinstance(target, ast.Name):
            local = f"{fn.qualname}.<locals>.{target.id}"
            if local in self.functions:
                return local
            if target.id in self.functions:
                return target.id
        elif isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name) and \
                target.value.id in ("self", "cls") and fn.class_name:
            method = f"{fn.class_name}.{target.attr}"
            if method in self.functions:
                return method
        return None

    def _edges(self, fn: FunctionNode) -> None:
        for node in self.body_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = self._resolve(fn, node)
            if callee is not None:
                fn.calls.append((callee, node))
            callback = self._callback_target(fn, node)
            if callback is not None:
                fn.calls.append((callback, node))

    # -- reachability -------------------------------------------------------
    def loop_reachable(self) -> Dict[str, List[str]]:
        """Map of function qualname → call chain from an async root, for
        every function that executes on the event loop. Roots are all
        ``async def``s; edges never cross a thread hop (see module doc)."""
        chains: Dict[str, List[str]] = {}
        stack: List[Tuple[str, List[str]]] = [
            (name, [name]) for name, fn in self.functions.items()
            if fn.is_async]
        while stack:
            name, chain = stack.pop()
            if name in chains:
                continue
            chains[name] = chain
            for callee, _site in self.functions[name].calls:
                if callee not in chains:
                    stack.append((callee, chain + [callee]))
        return chains
