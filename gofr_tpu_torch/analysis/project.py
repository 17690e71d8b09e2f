"""Whole-program symbol table + cross-module call graph (graftcheck v2).

The module-local graph (``callgraph.py``) stops at the file boundary, so
every rule that needs reachability — "is this blocking call reachable
from an ``async def``?" — went blind the moment a helper moved to its
own module. :class:`ProjectGraph` stitches the per-module graphs into
one program-wide graph:

- **symbol table** — every scanned module under a dotted name derived
  from its repo-relative path, every module-level function, every class
  (with bases and methods) indexed project-wide;
- **import edges** — ``from x import y`` / ``import x`` call sites
  resolve through each module's alias table, then through the symbol
  table by *dotted-suffix match* (fixture packages and the real tree
  rarely share an import root with the scan root);
- **typed attribute edges** — ``self.engine.submit(...)`` resolves when
  the receiver's class is assignable from what the tree actually
  constructs: ``self.engine = GenerationEngine(...)`` in a constructor,
  an annotated parameter (``pool: PagePool``), an ``AnnAssign``, or a
  parameter whose annotation names a project class. Attribute chains
  resolve transitively (``self.container.engine.tick`` walks two class
  attribute tables);
- **duck-typed edges** — a method name defined by *exactly one* project
  class (and not a ubiquitous container/IO verb) resolves to that class:
  the container/engine plumbing passes duck-typed collaborators around
  without annotations, and a unique name is as good as a type;
- **loop-callback edges** — ``call_soon``/``call_later``/
  ``add_done_callback`` targets run on the loop, exactly as in the
  module-local graph.

Thread hops stay invisible by construction: a callable *passed* to
``run_in_executor`` / ``asyncio.to_thread`` is an argument, not a call,
so offloaded work falls out of every reachability query for free.

Known blind spots (documented in docs/references/static-analysis-torch.md):
calls through dynamic dispatch tables, ``getattr`` strings, decorators
that rebind, re-exports through ``__init__`` shims, and duck-typed
names shared by several classes (ambiguity drops the edge — the graph
is deliberately conservative toward *fewer* edges, never wrong ones).

``cross_module=False`` disables every cross-module mechanism and
reproduces the v1 module-local behavior exactly — regression
tests pin a cross-module event-loop block that project mode catches and
local mode provably misses.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from gofr_tpu_torch.analysis.callgraph import CallGraph, FunctionNode
from gofr_tpu_torch.analysis.engine import ModuleInfo

# (module relpath, function qualname) — the project-wide function id
FuncRef = Tuple[str, str]
# (module relpath, class qualname)
ClassRef = Tuple[str, str]

# method names too generic to duck-type: one project class defining
# ``get`` must not capture every ``obj.get(...)`` in the tree
_COMMON_METHODS = {
    "get", "set", "put", "pop", "push", "add", "remove", "append",
    "extend", "insert", "clear", "copy", "update", "keys", "values",
    "items", "close", "open", "read", "write", "send", "recv", "flush",
    "run", "start", "stop", "reset", "submit", "result", "done",
    "cancel", "wait", "notify", "join", "acquire", "release", "item",
    "count", "index", "sort", "split", "strip", "format", "encode",
    "decode", "register", "stats", "setdefault", "render", "match",
    "group", "search", "exists", "mkdir", "touch", "next", "emit",
}

_LOOP_CALLBACK_ARG = {
    "call_soon": 0,
    "call_soon_threadsafe": 0,
    "call_later": 1,
    "call_at": 1,
    "add_done_callback": 0,
}


def module_dotted_name(relpath: str) -> str:
    """``gofr_tpu_torch/tpu/generate.py`` → ``gofr_tpu_torch.tpu.generate``;
    package ``__init__.py`` files name the package itself."""
    parts = relpath[:-3].split("/") if relpath.endswith(".py") \
        else relpath.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class ClassInfo:
    """One class definition: bases (unresolved dotted names), method
    table, and the inferred types of its instance attributes."""

    __slots__ = ("ref", "name", "qualname", "node", "bases",
                 "methods", "attr_types")

    def __init__(self, ref: ClassRef, node: ast.ClassDef, qualname: str):
        self.ref = ref
        self.name = node.name
        self.qualname = qualname
        self.node = node
        self.bases: List[str] = []      # dotted names, resolved lazily
        self.methods: Dict[str, str] = {}   # method name -> fn qualname
        self.attr_types: Dict[str, ClassRef] = {}


class ProjectGraph:
    """Project-wide function table + call edges over ``modules``.

    ``cross_module=False`` keeps only module-local edges (the v1
    behavior); rules use it to regression-test what interprocedural
    analysis buys.
    """

    def __init__(self, modules: Sequence[ModuleInfo],
                 cross_module: bool = True):
        self.cross_module = cross_module
        self.modules: Dict[str, ModuleInfo] = {
            m.relpath: m for m in modules}
        self.graphs: Dict[str, CallGraph] = {
            rel: CallGraph(m) for rel, m in self.modules.items()}
        self.functions: Dict[FuncRef, FunctionNode] = {}
        self._fn_module: Dict[int, FuncRef] = {}   # id(fn node) -> ref
        for rel, graph in self.graphs.items():
            for qual, fn in graph.functions.items():
                self.functions[(rel, qual)] = fn
                self._fn_module[id(fn.node)] = (rel, qual)

        # dotted module names, exact + suffix index
        self._dotted: Dict[str, str] = {}
        for rel in self.modules:
            self._dotted.setdefault(module_dotted_name(rel), rel)

        # class index
        self.classes: Dict[ClassRef, ClassInfo] = {}
        self._class_by_name: Dict[str, List[ClassRef]] = {}
        self._method_index: Dict[str, List[ClassRef]] = {}
        for rel, module in self.modules.items():
            self._collect_classes(rel, module)
        if cross_module:
            for info in self.classes.values():
                self._infer_attr_types(info)

        # call edges, lifted project-wide
        self._edges: Dict[FuncRef, List[Tuple[FuncRef, ast.Call]]] = {}
        self._callers: Dict[FuncRef, List[Tuple[FuncRef, ast.Call]]] = {}
        self._local_env_cache: Dict[int, Dict[str, ClassRef]] = {}
        for ref in self.functions:
            self._edges[ref] = list(self._build_edges(ref))
        for caller, edges in self._edges.items():
            for callee, site in edges:
                self._callers.setdefault(callee, []).append((caller, site))

    # -- basic accessors ----------------------------------------------------
    def module_of(self, ref: FuncRef) -> ModuleInfo:
        return self.modules[ref[0]]

    def body_nodes(self, ref: FuncRef) -> Iterable[ast.AST]:
        """A function's own executed nodes (lambdas/comprehensions in,
        nested ``def``s out) — same semantics as the module graph."""
        return self.graphs[ref[0]].body_nodes(self.functions[ref])

    def calls(self, ref: FuncRef) -> List[Tuple[FuncRef, ast.Call]]:
        return self._edges.get(ref, [])

    def callers(self, ref: FuncRef) -> List[Tuple[FuncRef, ast.Call]]:
        return self._callers.get(ref, [])

    def ref_of_node(self, fn_node: ast.AST) -> Optional[FuncRef]:
        return self._fn_module.get(id(fn_node))

    def display(self, ref: FuncRef, relative_to: str) -> str:
        """Render a function for chain messages: bare qualname within
        the same module, ``stem.qualname`` across modules."""
        rel, qual = ref
        if rel == relative_to:
            return qual
        stem = rel.rsplit("/", 1)[-1]
        stem = stem[:-3] if stem.endswith(".py") else stem
        return f"{stem}.{qual}"

    # -- reachability -------------------------------------------------------
    def reachable(self, roots: Iterable[FuncRef]
                  ) -> Dict[FuncRef, List[FuncRef]]:
        """Map of function → call chain from the nearest root, for every
        function reachable from ``roots`` along call edges. Chains never
        cross a thread hop (executor-passed callables have no edge)."""
        chains: Dict[FuncRef, List[FuncRef]] = {}
        stack: List[Tuple[FuncRef, List[FuncRef]]] = [
            (ref, [ref]) for ref in sorted(roots)]
        stack.reverse()
        while stack:
            ref, chain = stack.pop()
            if ref in chains:
                continue
            chains[ref] = chain
            for callee, _site in self.calls(ref):
                if callee not in chains:
                    stack.append((callee, chain + [callee]))
        return chains

    def async_roots(self) -> List[FuncRef]:
        return [ref for ref, fn in self.functions.items() if fn.is_async]

    # -- class collection ---------------------------------------------------
    def _collect_classes(self, rel: str, module: ModuleInfo) -> None:
        def walk(tree: ast.AST, prefix: str) -> None:
            for child in ast.iter_child_nodes(tree):
                if isinstance(child, ast.ClassDef):
                    qual = f"{prefix}{child.name}"
                    ref = (rel, qual)
                    info = ClassInfo(ref, child, qual)
                    for base in child.bases:
                        dotted = module.dotted(base)
                        if dotted:
                            info.bases.append(dotted)
                    graph = self.graphs[rel]
                    for item in child.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            mqual = f"{qual}.{item.name}"
                            if mqual in graph.functions:
                                info.methods[item.name] = mqual
                    self.classes[ref] = info
                    self._class_by_name.setdefault(
                        child.name, []).append(ref)
                    for name in info.methods:
                        self._method_index.setdefault(
                            name, []).append(ref)
                    walk(child, prefix=f"{qual}.")
                elif not isinstance(child, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                    walk(child, prefix=prefix)
        walk(module.tree, prefix="")

    # -- symbol resolution --------------------------------------------------
    def _resolve_module(self, dotted: str) -> Optional[str]:
        """Exact dotted-name match, else unique suffix match — fixture
        packages import as ``from pkg.mod import f`` while the scan
        names them ``tests.analysis_fixtures...pkg.mod``."""
        rel = self._dotted.get(dotted)
        if rel is not None:
            return rel
        suffix = "." + dotted
        hits = [r for d, r in self._dotted.items() if d.endswith(suffix)]
        return hits[0] if len(hits) == 1 else None

    def resolve_symbol(self, dotted: str
                       ) -> Optional[Tuple[str, object]]:
        """Resolve ``pkg.mod.sym`` to ``("func", FuncRef)`` or
        ``("class", ClassRef)``. Returns None when the module part does
        not uniquely match a scanned module or the symbol is absent."""
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            rel = self._resolve_module(".".join(parts[:i]))
            if rel is None:
                continue
            rest = parts[i:]
            if len(rest) != 1:
                # pkg.mod.Class.method — not resolved (blind spot)
                return None
            sym = rest[0]
            if sym in self.graphs[rel].functions:
                return ("func", (rel, sym))
            if (rel, sym) in self.classes:
                return ("class", (rel, sym))
            return None
        return None

    def _resolve_class_name(self, module: ModuleInfo,
                            node: ast.AST) -> Optional[ClassRef]:
        """A constructor/annotation expression → project class."""
        dotted = module.dotted(node)
        if dotted is None:
            return None
        # same-module class first (bare name, no import alias)
        if "." not in dotted and (module.relpath, dotted) in self.classes:
            return (module.relpath, dotted)
        if "." in dotted:
            hit = self.resolve_symbol(dotted)
            if hit is not None and hit[0] == "class":
                return hit[1]  # type: ignore[return-value]
            # ``from x import Cls`` leaves dotted = "x.Cls"; suffix on
            # the class name alone as last resort
            dotted = dotted.rsplit(".", 1)[-1]
        refs = self._class_by_name.get(dotted, [])
        return refs[0] if len(refs) == 1 else None

    # -- type inference -----------------------------------------------------
    def _infer_attr_types(self, info: ClassInfo) -> None:
        rel = info.ref[0]
        module = self.modules[rel]
        graph = self.graphs[rel]
        for mname, mqual in info.methods.items():
            fn = graph.functions[mqual]
            ann_params = self._param_annotations(module, fn.node)
            for node in graph.body_nodes(fn):
                target = None
                value = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    target = node.target
                    ann = self._resolve_class_name(module, node.annotation)
                    if ann is not None and _is_self_attr(target):
                        info.attr_types.setdefault(target.attr, ann)
                    continue
                if not _is_self_attr(target):
                    continue
                inferred = None
                if isinstance(value, ast.Call):
                    inferred = self._resolve_class_name(module, value.func)
                elif isinstance(value, ast.Name):
                    inferred = ann_params.get(value.id)
                if inferred is not None:
                    info.attr_types.setdefault(target.attr, inferred)

    def _param_annotations(self, module: ModuleInfo,
                           fn_node: ast.AST) -> Dict[str, ClassRef]:
        out: Dict[str, ClassRef] = {}
        args = fn_node.args
        for arg in (list(args.posonlyargs) + list(args.args)
                    + list(args.kwonlyargs)):
            if arg.annotation is not None:
                ref = self._resolve_class_name(module, arg.annotation)
                if ref is not None:
                    out[arg.arg] = ref
        return out

    def _local_env(self, ref: FuncRef) -> Dict[str, ClassRef]:
        """name → class for a function's locals: annotated params,
        ``x = Cls(...)`` constructor assigns, ``x: Cls`` AnnAssigns."""
        fn = self.functions[ref]
        cached = self._local_env_cache.get(id(fn.node))
        if cached is not None:
            return cached
        module = self.modules[ref[0]]
        graph = self.graphs[ref[0]]
        env = dict(self._param_annotations(module, fn.node))
        for node in graph.body_nodes(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                inferred = self._resolve_class_name(module, node.value.func)
                if inferred is not None:
                    env.setdefault(node.targets[0].id, inferred)
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                inferred = self._resolve_class_name(module, node.annotation)
                if inferred is not None:
                    env.setdefault(node.target.id, inferred)
        self._local_env_cache[id(fn.node)] = env
        return env

    def class_of_function(self, ref: FuncRef) -> Optional[ClassInfo]:
        fn = self.functions[ref]
        if fn.class_name is None:
            return None
        qual = ref[1]
        if "." not in qual:
            return None
        return self.classes.get((ref[0], qual.rsplit(".", 1)[0]))

    def type_of(self, ref: FuncRef, expr: ast.AST) -> Optional[ClassRef]:
        """Infer the class of a receiver expression inside ``ref``:
        locals/params by assignment or annotation, ``self.attr`` through
        the class attribute table, chains transitively."""
        if not self.cross_module:
            return None
        if isinstance(expr, ast.Name):
            if expr.id in ("self", "cls"):
                info = self.class_of_function(ref)
                return info.ref if info is not None else None
            return self._local_env(ref).get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.type_of(ref, expr.value)
            if base is None:
                return None
            info = self.classes.get(base)
            while info is not None:
                if expr.attr in info.attr_types:
                    return info.attr_types[expr.attr]
                info = self._first_base(info)
            return None
        return None

    def _first_base(self, info: ClassInfo) -> Optional[ClassInfo]:
        for dotted in info.bases:
            ref = self._resolve_class_name(
                self.modules[info.ref[0]],
                ast.parse(dotted, mode="eval").body)
            if ref is not None and ref != info.ref:
                return self.classes.get(ref)
        return None

    def _lookup_method(self, cref: ClassRef,
                       name: str) -> Optional[FuncRef]:
        seen: Set[ClassRef] = set()
        info = self.classes.get(cref)
        while info is not None and info.ref not in seen:
            seen.add(info.ref)
            mqual = info.methods.get(name)
            if mqual is not None:
                return (info.ref[0], mqual)
            info = self._first_base(info)
        return None

    # -- edge construction --------------------------------------------------
    def _build_edges(self, ref: FuncRef
                     ) -> Iterable[Tuple[FuncRef, ast.Call]]:
        rel, _qual = ref
        graph = self.graphs[rel]
        fn = self.functions[ref]
        locally_resolved: Set[int] = set()
        for callee_qual, site in fn.calls:
            locally_resolved.add(id(site))
            yield ((rel, callee_qual), site)
        if not self.cross_module:
            return
        module = self.modules[rel]
        for node in graph.body_nodes(fn):
            if not isinstance(node, ast.Call) or id(node) in locally_resolved:
                continue
            callee = self._resolve_cross(module, ref, node)
            if callee is not None:
                yield (callee, node)
            target = self._cross_callback_target(module, ref, node)
            if target is not None:
                yield (target, node)

    def _resolve_cross(self, module: ModuleInfo, ref: FuncRef,
                       call: ast.Call) -> Optional[FuncRef]:
        func = call.func
        if isinstance(func, ast.Name):
            dotted = module.import_aliases.get(func.id)
            if dotted and "." in dotted:
                hit = self.resolve_symbol(dotted)
                if hit is not None and hit[0] == "func":
                    return hit[1]  # type: ignore[return-value]
            return None
        if not isinstance(func, ast.Attribute):
            return None
        # typed receiver: self.engine.submit(...), pool.alloc(...)
        rtype = self.type_of(ref, func.value)
        if rtype is not None:
            hit = self._lookup_method(rtype, func.attr)
            if hit is not None:
                return hit
        # module attribute: helpers.prep(...) with ``import helpers``
        dotted = module.dotted(func)
        if dotted is not None and "." in dotted:
            hit = self.resolve_symbol(dotted)
            if hit is not None and hit[0] == "func":
                return hit[1]  # type: ignore[return-value]
        # duck-typed: a method name only one project class defines
        if func.attr not in _COMMON_METHODS \
                and not func.attr.startswith("__"):
            owners = self._method_index.get(func.attr, [])
            if len(owners) == 1:
                return self._lookup_method(owners[0], func.attr)
        return None

    def _cross_callback_target(self, module: ModuleInfo, ref: FuncRef,
                               call: ast.Call) -> Optional[FuncRef]:
        """Loop-scheduled callbacks whose target is an imported
        function: ``loop.call_soon(imported_fn)`` runs on the loop."""
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        index = _LOOP_CALLBACK_ARG.get(func.attr)
        if index is None or len(call.args) <= index:
            return None
        target = call.args[index]
        if isinstance(target, ast.Name):
            dotted = module.import_aliases.get(target.id)
            if dotted and "." in dotted:
                hit = self.resolve_symbol(dotted)
                if hit is not None and hit[0] == "func":
                    return hit[1]  # type: ignore[return-value]
        return None


def _is_self_attr(node: Optional[ast.AST]) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")
