"""GT015 static-output reuse: reading a graph's output after the next
replay overwrote it.

The JAX package's GT015 guards donation: after a ``donate_argnums``
dispatch the donated array is deleted, and a read of it raises or reads
garbage. A CUDA graph's counterpart is its *static output*: every replay
writes its results into the same tensors the capture returned
(``capture.record``'s ``out``, the engine's ``entry.out`` /
``rung.first``, the executor's ``exe.out``). A tensor that aliases one of
them — the output itself, a slice or a view of it — silently takes the
next replay's values; nothing raises, on any device. A graph's static
inputs are the mirror case: a replay reads them when it runs on the
card, not when ``replay()`` returns.

Detection, per function body, with the value-flow pass (``dataflow.py``):

1. **Find graphs and their outputs.** ``g, out, ... = capture.record(...)``
   (or a helper of the module that returns it) pairs ``g`` with ``out``;
   a replay ``P.graph.replay()`` pairs with ``P.out`` / ``P.outs`` /
   ``P.first`` / ``P.output(s)``; an assignment inside ``with
   torch.cuda.graph(g):`` is ``g``'s output.
2. **Held across a replay** (JAX's stale read): an alias of an output
   (the output, a subscript, or a chain of view methods — ``.view``,
   ``.reshape``, ``.narrow``, ``.detach``, ``.T``...) bound between two
   replays of the same graph, and loaded after the later one with no
   rebind in between. ``.clone()`` (or any call that copies:
   ``.tolist()``, ``.cpu()``, ``.to(...)``, a ``copy_`` into a buffer of
   one's own) makes a value of one's own and passes.
3. **Held in a loop** (JAX's loop-carried donation): a replay inside a
   loop whose body appends or stores an alias of the output into a
   container — every entry is the last replay's.
4. **Input written during a replay**: a graph's static inputs are the
   paths the function writes (``copy_``, ``fill_``, ``zero_``,
   ``index_copy_``, subscript store) before a replay; a write to one
   after the replay, inside ``with torch.cuda.stream(...)`` (another
   stream) and with no ``wait_stream`` / ``wait_event`` /
   ``synchronize`` / ``.wait(...)`` between, races the replay in
   flight.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from gofr_tpu_torch.analysis.dataflow import ValueFlow, dotted_path
from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule
from gofr_tpu_torch.analysis.rules.gt003_recompile import (
    is_graph_context,
    is_record,
    record_helpers,
)

_OUTPUT_ATTRS = ("out", "outs", "first", "output", "outputs")
# methods that return a view (or the tensor itself): still the output
_ALIAS_METHODS = {"view", "view_as", "reshape", "narrow", "select",
                  "unsqueeze", "squeeze", "flatten", "detach", "contiguous",
                  "t", "transpose", "permute", "expand", "expand_as",
                  "unbind", "split", "chunk", "as_strided", "unflatten",
                  "movedim", "__getitem__"}
_ALIAS_ATTRS = {"T", "mT", "data", "real", "imag"}
_WRITE_METHODS = {"copy_", "fill_", "zero_", "index_copy_", "index_put_",
                  "scatter_", "masked_fill_"}
_FENCES = {"wait_stream", "wait_event", "synchronize", "wait"}


def _alias_root(expr: ast.AST) -> Optional[str]:
    """The dotted path an expression aliases, through subscripts, view
    methods and view attributes; None for anything that copies."""
    while True:
        path = dotted_path(expr)
        if path is not None:
            return path
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        elif isinstance(expr, ast.Attribute) and expr.attr in _ALIAS_ATTRS:
            expr = expr.value
        elif isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in _ALIAS_METHODS:
            expr = expr.func.value
        else:
            return None


def _covers(root: str, path: str) -> bool:
    return path == root or path.startswith(root + ".")


class DonateUseRule(Rule):
    rule_id = "GT015"
    title = "static-output-reuse (CUDA graph)"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        if "replay" not in module.source:
            return []
        helpers = set(record_helpers(module))
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(module, fn, helpers))
        return findings

    # -- step 1: graphs, outputs, replays ------------------------------------
    def _outputs(self, module: ModuleInfo, fn: ast.AST,
                 helpers: Set[str]) -> Dict[str, Set[str]]:
        """graph path → its static-output paths, from this function's
        captures (the ``P.graph`` form is resolved at the replay)."""
        outputs: Dict[str, Set[str]] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Tuple) and \
                    isinstance(node.value, ast.Call) and (
                        is_record(module, node.value) or
                        getattr(node.value.func, "attr",
                                getattr(node.value.func, "id", None))
                        in helpers):
                elts = node.targets[0].elts
                graph = dotted_path(elts[0]) if elts else None
                out = dotted_path(elts[1]) if len(elts) > 1 else None
                if graph is not None and out is not None:
                    outputs.setdefault(graph, set()).add(out)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if not (isinstance(expr, ast.Call) and expr.args and
                            is_graph_context(module, expr)):
                        continue
                    graph = dotted_path(expr.args[0])
                    for stmt in node.body:
                        if isinstance(stmt, ast.Assign) and graph:
                            for target in stmt.targets:
                                path = dotted_path(target)
                                if path is not None:
                                    outputs.setdefault(graph, set()).add(
                                        path)
        return outputs

    def _replays(self, flow: ValueFlow, fn: ast.AST
                 ) -> List[Tuple[int, str, ast.Call]]:
        out = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "replay":
                graph = dotted_path(node.func.value)
                stmt = flow.stmt_index(node)
                if graph is not None and stmt is not None:
                    out.append((stmt, graph, node))
        return sorted(out, key=lambda item: item[0])

    @staticmethod
    def _outputs_of(graph: str, outputs: Dict[str, Set[str]]) -> Set[str]:
        found = set(outputs.get(graph, ()))
        if "." in graph:
            holder = graph.rsplit(".", 1)[0]
            found.update(f"{holder}.{attr}" for attr in _OUTPUT_ATTRS)
        return found

    # -- steps 2-4 -----------------------------------------------------------
    def _check_function(self, module: ModuleInfo, fn: ast.AST,
                        helpers: Set[str]) -> Iterable[Finding]:
        flow = ValueFlow(fn)
        replays = self._replays(flow, fn)
        if not replays:
            return []
        outputs = self._outputs(module, fn, helpers)
        findings: List[Finding] = []
        by_graph: Dict[str, List[Tuple[int, ast.Call]]] = {}
        for stmt, graph, node in replays:
            by_graph.setdefault(graph, []).append((stmt, node))
        for graph, sites in by_graph.items():
            outs = self._outputs_of(graph, outputs)
            if not outs:
                continue
            findings.extend(self._held(module, fn, flow, graph, sites, outs))
            findings.extend(self._loop_held(module, fn, flow, graph, sites,
                                            outs))
            findings.extend(self._input_race(module, fn, flow, graph, sites))
        return findings

    def _held(self, module, fn, flow, graph, sites, outs):
        findings = []
        stmts = [stmt for stmt, _ in sites]
        for fact in flow.assigns_in_order:
            root = _alias_root(fact.value) if fact.value is not None \
                else None
            if root is None or not any(_covers(o, root) for o in outs):
                continue
            later = [s for s in stmts if s > fact.stmt]
            earlier = [s for s in stmts if s < fact.stmt]
            if not later or not earlier:
                continue
            reads = flow.loads_after(fact.path, later[0])
            if reads:
                findings.append(Finding(
                    rule=self.rule_id, path=module.relpath,
                    line=reads[0][0],
                    message=(
                        f"static-output reuse: '{fact.path}' aliases "
                        f"'{root}', the static output of graph '{graph}', "
                        f"and is read after the replay at line "
                        f"{self._line(flow, fn, later[0])} overwrote it — "
                        f"take '.clone()' (or copy_ into a buffer of its "
                        f"own) before the next replay"),
                    severity=self.severity,
                    key=f"static-output {fact.path} in {fn.name}"))
        return findings

    @staticmethod
    def _line(flow: ValueFlow, fn: ast.AST, stmt: int) -> int:
        for node in ast.walk(fn):
            if flow.stmt_index(node) == stmt and hasattr(node, "lineno"):
                return node.lineno
        return fn.lineno

    def _loop_held(self, module, fn, flow, graph, sites, outs):
        findings = []
        for _, node in sites:
            loop = self._enclosing_loop(module, node, fn)
            if loop is None:
                continue
            for sub in ast.walk(loop):
                stored = None
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in ("append", "extend", "insert") and \
                        sub.args:
                    stored = sub.args[-1]
                elif isinstance(sub, (ast.Yield, ast.YieldFrom)):
                    stored = sub.value
                elif isinstance(sub, ast.Assign) and any(
                        isinstance(t, ast.Subscript) for t in sub.targets):
                    stored = sub.value
                if stored is None:
                    continue
                root = _alias_root(stored)
                if root is not None and any(_covers(o, root) for o in outs):
                    findings.append(Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=sub.lineno,
                        message=(
                            f"static-output reuse: graph '{graph}' replays "
                            f"inside a loop that keeps '{root}', its "
                            f"static output, uncopied — every entry is "
                            f"the last replay's; keep '.clone()'"),
                        severity=self.severity,
                        key=f"loop-held {root} in {fn.name}"))
        return findings

    def _input_race(self, module, fn, flow, graph, sites):
        writes = []   # (stmt, path, node)
        for node in ast.walk(fn):
            path = None
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _WRITE_METHODS:
                path = _alias_root(node.func.value)
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Subscript):
                        path = _alias_root(target.value)
            stmt = flow.stmt_index(node)
            if path is not None and stmt is not None:
                writes.append((stmt, path, node))
        fences = sorted(flow.stmt_index(n) for n in ast.walk(fn)
                        if isinstance(n, ast.Call) and
                        isinstance(n.func, ast.Attribute) and
                        n.func.attr in _FENCES and
                        flow.stmt_index(n) is not None)
        findings = []
        first = sites[0][0]
        inputs = {path for stmt, path, _ in writes if stmt < first}
        for replay_stmt, replay in sites:
            for stmt, path, node in writes:
                if stmt <= replay_stmt or path not in inputs:
                    continue
                if any(replay_stmt < f <= stmt for f in fences):
                    continue
                if not self._on_other_stream(module, node, fn):
                    continue
                findings.append(Finding(
                    rule=self.rule_id, path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"static-output reuse: static input '{path}' of "
                        f"graph '{graph}' is written on another stream "
                        f"while the replay at line {replay.lineno} may "
                        f"still read it — wait for the replay's stream "
                        f"(wait_stream/wait_event) first"),
                    severity=self.severity,
                    key=f"input-race {path} in {fn.name}"))
        return findings

    @staticmethod
    def _on_other_stream(module: ModuleInfo, node: ast.AST,
                         fn: ast.AST) -> bool:
        cursor = module.parents.get(node)
        while cursor is not None and cursor is not fn:
            if isinstance(cursor, (ast.With, ast.AsyncWith)):
                for item in cursor.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call) and \
                            module.dotted(expr.func) == "torch.cuda.stream":
                        return True
            cursor = module.parents.get(cursor)
        return False

    @staticmethod
    def _enclosing_loop(module, node, fn_node):
        cursor = module.parents.get(node)
        while cursor is not None and cursor is not fn_node:
            if isinstance(cursor, (ast.For, ast.AsyncFor, ast.While)):
                return cursor
            if isinstance(cursor, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.Lambda)):
                return None
            cursor = module.parents.get(cursor)
        return None
