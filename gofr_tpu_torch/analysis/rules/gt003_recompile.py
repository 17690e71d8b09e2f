"""GT003 recapture hazard: CUDA-graph capture discipline, checked ahead of
deploy.

The port's counterpart of a ``jax.jit`` compile is a CUDA-graph capture:
every capture goes through ``capture.record(device, pool, eager, body)``
(``gofr_tpu_torch/tpu/capture.py``), and a served shape replays the graph
its table holds. The compile ledger can *count* serve-time captures after
they already stalled traffic; this rule catches the classic causes at
review time. It is the JAX package's GT003 with each check given its
graph counterpart:

- **capture-per-call** (``hazard=fresh-capture``, JAX's ``fresh-jit``): a
  ``torch.cuda.CUDAGraph()`` or a capture (``capture.record(...)``, or a
  helper of the module that hands it its callables) whose graph is
  neither returned nor stored in an attribute or a table — it is
  captured again on every call. Keep the graph in a table the engine
  holds (``GenerationEngine._graphs``, ``model.compiled``).
- **unhashable key** (``hazard=unhashable-key``, JAX's
  ``unhashable-static``): a list/dict/set literal inside a graph table's
  key raises at the lookup.
- **raw-length key** (``hazard=raw-key``, JAX's ``shape-arg``): a graph
  table's key built from a bare ``len(...)`` / ``.shape[i]`` /
  ``.size(i)`` that is not first rounded to a declared rung (a call
  such as ``_bucket_for(len(x))`` or ``next(b for b in BUCKETS if b >=
  len(x))`` rounds it) — one capture per distinct request size.
- **raw-len capture shape** (``hazard=raw-shape``): ``torch.zeros``-family
  constructors whose shape holds a bare ``len(...)``, inside a graph body
  or in a function that captures (its static buffers are the capture's
  shapes): an unbucketed dimension mints one graph per distinct length.
- **live-count slice width** (``hazard=page-width``): a graph body that
  slices to a ``len(...)``-derived bound (``table[:, :len(pages)]``).
  The width is the live count at capture and every replay keeps it:
  slice to a declared ladder rung instead.

Graph tables are found module-wide: containers that take a graph (or an
object holding one) by subscript store. Graph bodies are those of GT004
(:func:`graph_bodies`). Everything here is module-local, as in JAX.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from gofr_tpu_torch.analysis.dataflow import dotted_path
from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

_TORCH_CTORS = {"zeros", "ones", "full", "empty", "arange", "rand",
                "randn", "randint"}
# calls that keep a length as it is: ``min(len(x), cap)`` is not a rung
_NOT_ROUNDING = {"int", "tuple", "list", "min", "max", "abs", "str",
                 "float", "len"}
_CAPTURE_SUFFIX = "capture.record"
_GRAPH_CLASSES = {"torch.cuda.CUDAGraph"}
_GRAPH_CONTEXTS = {"torch.cuda.graph"}
_GRAPH_TOKENS = ("record(", "CUDAGraph", "cuda.graph(", ".replay(")
# (eager, body) positions and keywords of ``capture.record``
_RECORD_BODIES = ((2, "eager"), (3, "body"))


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _call_name(func: ast.AST) -> Optional[str]:
    """``self._record`` / ``_record`` → ``"_record"``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def mentions_graphs(module: ModuleInfo) -> bool:
    """A cheap probe: modules that capture or replay no graph are
    skipped by the three CUDA-graph rules."""
    return any(token in module.source for token in _GRAPH_TOKENS)


def is_record(module: ModuleInfo, call: ast.Call) -> bool:
    """A ``capture.record(...)`` call (through any import alias)."""
    dotted = module.dotted(call.func)
    return dotted is not None and (
        dotted == _CAPTURE_SUFFIX or dotted.endswith("." + _CAPTURE_SUFFIX))


def is_graph_ctor(module: ModuleInfo, call: ast.Call) -> bool:
    return module.dotted(call.func) in _GRAPH_CLASSES


def is_graph_context(module: ModuleInfo, call: ast.Call) -> bool:
    return module.dotted(call.func) in _GRAPH_CONTEXTS


def record_helpers(module: ModuleInfo) -> Dict[str, List[Tuple[int, str]]]:
    """Functions of the module that hand their own parameters to
    ``capture.record`` as its eager/body callables (the engine's
    ``_record``): name → [(call-site position, parameter name)], the
    position counted without ``self``/``cls``."""
    helpers: Dict[str, List[Tuple[int, str]]] = {}
    for fn in _functions(module.tree):
        params = [a.arg for a in fn.args.args]
        offset = 1 if params and params[0] in ("self", "cls") else 0
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and is_record(module, node)):
                continue
            for arg in _record_args(node):
                if isinstance(arg, ast.Name) and arg.id in params:
                    helpers.setdefault(fn.name, []).append(
                        (params.index(arg.id) - offset, arg.id))
    return helpers


def _record_args(call: ast.Call) -> List[ast.AST]:
    out = []
    for index, name in _RECORD_BODIES:
        if index < len(call.args):
            out.append(call.args[index])
        for kw in call.keywords:
            if kw.arg == name:
                out.append(kw.value)
    return out


def capture_calls(module: ModuleInfo) -> List[Tuple[ast.Call, List[ast.AST]]]:
    """Every capture call of the module with the callables it captures:
    ``capture.record`` and calls of a :func:`record_helpers` helper."""
    helpers = record_helpers(module)
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if is_record(module, node):
            out.append((node, _record_args(node)))
            continue
        name = _call_name(node.func)
        if name in helpers:
            out.append((node, [node.args[pos] for pos, param in
                               helpers[name]
                               if 0 <= pos < len(node.args)] +
                        [kw.value for kw in node.keywords
                         if kw.arg in {p for _, p in helpers[name]}]))
    return out


def _enclosing_class(module: ModuleInfo, node: ast.AST) -> Optional[ast.AST]:
    cursor = module.parents.get(node)
    while cursor is not None:
        if isinstance(cursor, ast.ClassDef):
            return cursor
        cursor = module.parents.get(cursor)
    return None


def _resolve_callable(module: ModuleInfo, site: ast.AST,
                      expr: ast.AST) -> List[ast.AST]:
    """The defs/lambdas a callable expression names: a lambda itself, a
    def of that name in an enclosing function or the module, or
    ``self.meth`` of the enclosing class."""
    if isinstance(expr, ast.Lambda):
        return [expr]
    if isinstance(expr, ast.Name):
        scope = module.enclosing_function(site)
        while scope is not None:
            hits = [n for n in ast.walk(scope)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name == expr.id and n is not scope]
            if hits:
                return hits
            scope = module.enclosing_function(scope)
        return [n for n in module.tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name == expr.id]
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        cls = _enclosing_class(module, site)
        if cls is not None:
            return [n for n in cls.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name == expr.attr]
    return []


def graph_bodies(module: ModuleInfo) -> List[Tuple[ast.AST, str]]:
    """Every node whose code runs inside a capture, with the name findings
    report it under: the eager and body callables handed to
    ``capture.record`` (or to a helper that hands them on), the blocks of
    ``with torch.cuda.graph(...)``, and the functions of the module that
    those call, transitively (``lambda: self._tick_body(key, active)``
    makes ``_tick_body`` a body, and what it calls through ``self.``).
    A def nested in a body is walked with it."""
    seen: Dict[int, Tuple[ast.AST, str]] = {}
    todo: List[ast.AST] = []

    def add(node: ast.AST, name: str) -> None:
        if id(node) not in seen:
            seen[id(node)] = (node, name)
            todo.append(node)

    for call, args in capture_calls(module):
        for arg in args:
            for target in _resolve_callable(module, call, arg):
                if isinstance(target, ast.Lambda):
                    fn = module.enclosing_function(call)
                    add(target, f"<lambda in {fn.name}>" if fn is not None
                        else "<lambda>")
                else:
                    add(target, target.name)
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call) and
                is_graph_context(module, item.context_expr)
                for item in node.items):
            fn = module.enclosing_function(node)
            add(node, "graph block in "
                f"{fn.name if fn is not None else '<module>'}")
    while todo:
        body = todo.pop()
        for sub in body_walk(body):
            if isinstance(sub, ast.Call):
                for callee in _resolve_callable(module, sub, sub.func):
                    if not isinstance(callee, ast.Lambda):
                        add(callee, callee.name)
    return list(seen.values())


def body_walk(body: ast.AST) -> Iterable[ast.AST]:
    """The nodes of a graph body: a lambda's expression, or the
    statements of a def or a with block (nested defs included)."""
    if isinstance(body, ast.Lambda):
        yield from ast.walk(body.body)
    else:
        for stmt in body.body:
            yield from ast.walk(stmt)


def _raw_length(node: ast.AST, module: ModuleInfo) -> Optional[str]:
    """A bare ``len(...)`` / ``.shape[i]`` / ``.size(i)`` in ``node`` that
    no rounding call wraps (any call but :data:`_NOT_ROUNDING` rounds)."""
    for sub in ast.walk(node):
        label = None
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "len":
            label = "len(...)"
        elif isinstance(sub, ast.Subscript) and \
                isinstance(sub.value, ast.Attribute) and \
                sub.value.attr == "shape":
            label = ".shape[...]"
        elif isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == "size" and sub.args:
            label = ".size(...)"
        if label is None:
            continue
        cursor, rounded = sub, False
        while cursor is not node and not rounded:
            cursor = module.parents.get(cursor)
            if cursor is None:
                break
            rounded = isinstance(cursor, ast.Call) and \
                _call_name(cursor.func) not in _NOT_ROUNDING
        if not rounded:
            return label
    return None


def _len_bound(node: ast.AST) -> bool:
    """A Subscript in ``node`` whose slice bounds hold ``len(...)``."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Subscript):
            continue
        parts = sub.slice.elts if isinstance(sub.slice, ast.Tuple) \
            else [sub.slice]
        for part in parts:
            if not isinstance(part, ast.Slice):
                continue
            for bound in (part.lower, part.upper, part.step):
                if bound is not None and any(
                        isinstance(n, ast.Call) and
                        isinstance(n.func, ast.Name) and n.func.id == "len"
                        for n in ast.walk(bound)):
                    return True
    return False


def _targets(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            out.extend(_targets(elt))
        return out
    if isinstance(node, ast.Starred):
        return _targets(node.value)
    return [node]


class _GraphFlow:
    """Which names, attributes and tables of a module hold graphs."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        self.producers: Set[str] = set()   # functions that return a graph
        self.tables: Set[str] = set()      # "self._graphs", "model.compiled"
        self.helpers = record_helpers(module)
        self._facts: Dict[int, Tuple[List[ast.Assign], List[ast.AST]]] = {}
        for fn in _functions(module.tree):
            nodes = list(ast.walk(fn))
            self._facts[id(fn)] = (
                [n for n in nodes if isinstance(n, ast.Assign)],
                [n.value for n in nodes
                 if isinstance(n, ast.Return) and n.value is not None])
        functions = list(_functions(module.tree))
        for _ in range(3):                 # a short fixpoint over returns
            before = len(self.producers)
            for fn in functions:
                returns = self._facts[id(fn)][1]
                if fn.name in self.producers or not returns:
                    continue
                held = self.held_in(fn)
                if any(self.holds(value, held) for value in returns):
                    self.producers.add(fn.name)
            if len(self.producers) == before:
                break
        for fn in functions:
            held = self.held_in(fn)
            for node in self._facts[id(fn)][0]:
                if len(node.targets) != 1 or \
                        not self.holds(node.value, held):
                    continue
                for target in _targets(node.targets[0]):
                    if isinstance(target, ast.Subscript):
                        path = dotted_path(target.value)
                        if path is not None:
                            self.tables.add(path)

    def is_capture(self, call: ast.AST, made_here: bool = False) -> bool:
        """A call that captures a graph (``made_here``: one that makes it
        here, not a producer that may keep it in its own table)."""
        if not isinstance(call, ast.Call):
            return False
        return (is_record(self.module, call)
                or is_graph_ctor(self.module, call)
                or _call_name(call.func) in self.helpers
                or (not made_here and
                    _call_name(call.func) in self.producers))

    def holds(self, expr: ast.AST, held: Set[str]) -> bool:
        """Does ``expr`` evaluate to (or build an object around) a graph?"""
        if self.is_capture(expr):
            return True
        path = dotted_path(expr)
        if path is not None and path in held:
            return True
        if isinstance(expr, ast.Call):
            # a holder built around a graph: _Graph(graph, out, ...)
            name = _call_name(expr.func) or ""
            return name.lstrip("_")[:1].isupper() and \
                any(self.holds(arg, held) for arg in expr.args)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self.holds(elt, held) for elt in expr.elts)
        return False

    def held_in(self, fn: ast.AST) -> Set[str]:
        """Paths of ``fn`` that hold a graph: names assigned one, and the
        objects whose attributes are (``exe.graph, ... = capture.record``
        makes ``exe`` a holder)."""
        held: Set[str] = set()
        assigns = self._facts[id(fn)][0]
        for _ in range(2):
            for node in assigns:
                if not self.holds(node.value, held):
                    continue
                for target in node.targets:
                    for leaf in _targets(target):
                        path = dotted_path(leaf)
                        if path is None:
                            continue
                        held.add(path)
                        if "." in path:
                            held.add(path.rsplit(".", 1)[0])
        return held


class RecompileHazardRule(Rule):
    rule_id = "GT003"
    title = "recapture-hazard (CUDA graph)"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        if not mentions_graphs(module):
            return []
        flow = _GraphFlow(module)
        findings: List[Finding] = []
        made: Dict[int, Tuple[ast.AST, List[ast.Call]]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and \
                    flow.is_capture(node, made_here=True):
                fn = module.enclosing_function(node)
                if fn is not None:
                    made.setdefault(id(fn), (fn, []))[1].append(node)
        for fn, calls in made.values():
            findings.extend(self._fresh_capture(module, flow, fn, calls))
        findings.extend(self._keys(module, flow))
        capturing = {id(module.enclosing_function(call))
                     for call, _ in capture_calls(module)}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and \
                    id(module.enclosing_function(node)) in capturing:
                findings.extend(self._raw_shape(module, node))
        for body, name in graph_bodies(module):
            for node in body_walk(body):
                if isinstance(node, ast.Call):
                    findings.extend(self._raw_shape(module, node, name))
                if isinstance(node, ast.Subscript) and \
                        not isinstance(module.parents.get(node),
                                       ast.Subscript) and _len_bound(node):
                    findings.append(Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=node.lineno,
                        message=(
                            f"recapture hazard [page-width]: graph body "
                            f"'{name}' slices to a len()-derived width — "
                            f"the live count at capture is frozen into "
                            f"every replay; slice to a declared ladder "
                            f"rung instead"),
                        severity=self.severity,
                        key=f"page-width in {name}"))
        unique = {}
        for finding in findings:
            unique[(finding.line, finding.key)] = finding
        return list(unique.values())

    # -- capture-per-call ----------------------------------------------------
    def _fresh_capture(self, module: ModuleInfo, flow: _GraphFlow,
                       fn: ast.AST, calls: List[ast.Call]
                       ) -> Iterable[Finding]:
        escaping = self._escaping(fn)
        findings = []
        for node in calls:
            parent = module.parents.get(node)
            if isinstance(parent, (ast.Return, ast.Lambda)):
                continue
            stored = False
            if isinstance(parent, ast.Assign):
                for target in parent.targets:
                    # the graph is the first leaf: ``graph, out, n = ...``
                    leaf = _targets(target)[0]
                    path = dotted_path(leaf)
                    if isinstance(leaf, (ast.Attribute, ast.Subscript)) \
                            or (path is not None and path in escaping):
                        stored = True
            elif isinstance(parent, (ast.Call, ast.Tuple, ast.List)):
                # handed on (a holder's constructor): judged at its store
                continue
            if stored:
                continue
            findings.append(Finding(
                rule=self.rule_id, path=module.relpath, line=node.lineno,
                message=(
                    f"recapture hazard [fresh-capture]: a CUDA graph "
                    f"captured inside '{fn.name}' is neither returned nor "
                    f"kept in a table — it is captured again on every "
                    f"call; keep it in a graph table keyed on a rung"),
                severity=self.severity,
                key=f"fresh-capture in {fn.name}"))
        return findings

    @staticmethod
    def _escaping(fn: ast.AST) -> Set[str]:
        """Local names whose value leaves the function: returned, stored
        in an attribute or a table, or folded into a local that does."""
        escaping: Set[str] = set()
        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        for _ in range(3):
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) and node.value is not None:
                    escaping.update(n.id for n in ast.walk(node.value)
                                    if isinstance(n, ast.Name))
            for node in assigns:
                leaves = [leaf for target in node.targets
                          for leaf in _targets(target)]
                if any(isinstance(leaf, (ast.Attribute, ast.Subscript)) or
                       (isinstance(leaf, ast.Name) and leaf.id in escaping)
                       for leaf in leaves):
                    escaping.update(n.id for n in ast.walk(node.value)
                                    if isinstance(n, ast.Name))
        return escaping

    # -- graph-table keys ----------------------------------------------------
    def _keys(self, module: ModuleInfo, flow: _GraphFlow
              ) -> Iterable[Finding]:
        findings = []
        for node in ast.walk(module.tree):
            key = container = None
            if isinstance(node, ast.Subscript):
                container, key = dotted_path(node.value), node.slice
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("get", "setdefault", "pop") and \
                    node.args:
                container, key = dotted_path(node.func.value), node.args[0]
            if container is None or container not in flow.tables:
                continue
            fn = module.enclosing_function(node)
            where = fn.name if fn is not None else "<module>"
            exprs = [key]
            if isinstance(key, ast.Name) and fn is not None:
                # one hop: the key's own assignments in this function
                exprs += [a.value for a in ast.walk(fn)
                          if isinstance(a, ast.Assign) and any(
                              isinstance(t, ast.Name) and t.id == key.id
                              for t in a.targets)]
            for expr in exprs:
                if any(isinstance(n, (ast.List, ast.Dict, ast.Set))
                       for n in ast.walk(expr)):
                    findings.append(Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=node.lineno,
                        message=(
                            f"recapture hazard [unhashable-key]: graph "
                            f"table '{container}' in '{where}' is keyed "
                            f"with an unhashable literal — use a tuple"),
                        severity=self.severity,
                        key=f"unhashable-key {container} in {where}"))
                    break
                src = _raw_length(expr, module)
                if src is not None:
                    findings.append(Finding(
                        rule=self.rule_id, path=module.relpath,
                        line=node.lineno,
                        message=(
                            f"recapture hazard [raw-key]: graph table "
                            f"'{container}' in '{where}' is keyed on a "
                            f"bare {src} — one capture per distinct "
                            f"size; round it to a declared rung first"),
                        severity=self.severity,
                        key=f"raw-key {container} in {where}"))
                    break
        return findings

    # -- capture shapes --------------------------------------------------------
    def _raw_shape(self, module: ModuleInfo, call: ast.Call,
                   where: Optional[str] = None) -> Iterable[Finding]:
        dotted = module.dotted(call.func)
        if dotted is None:
            return ()
        root, _, ctor = dotted.rpartition(".")
        if ctor not in _TORCH_CTORS or root != "torch" or not call.args:
            return ()
        shape = call.args[0]
        elements = (shape.elts if isinstance(shape, (ast.Tuple, ast.List))
                    else list(call.args))
        for element in elements:
            if isinstance(element, ast.Call) and \
                    isinstance(element.func, ast.Name) and \
                    element.func.id == "len":
                if where is None:
                    fn = module.enclosing_function(call)
                    where = fn.name if fn is not None else "<module>"
                return (Finding(
                    rule=self.rule_id, path=module.relpath, line=call.lineno,
                    message=(
                        f"recapture hazard [raw-shape]: a capture's buffer "
                        f"in '{where}' is shaped by a bare len(...) — every "
                        f"distinct length mints one graph; round up to a "
                        f"declared bucket rung first"),
                    severity=self.severity,
                    key=f"raw-shape in {where}"),)
        return ()
