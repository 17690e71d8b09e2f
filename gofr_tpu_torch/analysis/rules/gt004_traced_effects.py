"""GT004 capture side effects: host-world calls inside CUDA-graph bodies.

A CUDA graph records the kernels its body launches, nothing else: the
host code of the body runs at the capture (and at the eager run
``capture.record`` makes first), then never again — every replay is the
kernels alone. It is the JAX package's GT004 with the jit trace replaced
by the capture:

- a ``print`` / logger call logs once, at capture, not per step;
- a Manager metric observation (``increment_counter`` etc.) counts the
  capture, not the replays — record metrics at the dispatch site;
- a host sync (GT001's torch list: ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``,
  ``.synchronize()``) inside a capture raises
  (``cudaErrorStreamCaptureUnsupported``); in the eager run under
  ``set_sync_debug_mode("error")`` it raises too;
- host randomness (``random.*``, ``np.random.*``) is drawn once, at
  capture, and every replay reuses the draw;
- a Python ``if`` on a tensor's value needs a sync at capture and then
  freezes the branch the capture took (JAX: a concretization error).
  Structure checks stay exempt, as in JAX's rule: ``x is None``,
  ``isinstance(...)``, ``x.shape/ndim/dtype/device``, ``len(x)``.

Bodies (:func:`~gofr_tpu_torch.analysis.rules.gt003_recompile.
graph_bodies`) are resolved module-locally: the ``eager`` and ``body``
callables handed to ``capture.record`` (or to a helper of the module
that hands them on, the engine's ``_record``), the functions a lambda of
those calls directly, the blocks of ``with torch.cuda.graph(...)``, and
every ``def`` nested in them. A tensor is a parameter annotated
``torch.Tensor`` or a name the body assigns from a ``torch.*`` call or
from a tensor's method.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule
from gofr_tpu_torch.analysis.rules.gt001_event_loop import (
    BLOCKING_METHODS,
)
from gofr_tpu_torch.analysis.rules.gt003_recompile import (
    body_walk,
    graph_bodies,
    mentions_graphs,
)

_LOGGER_METHODS = {"debug", "info", "warn", "warning", "error", "exception",
                   "critical", "fatal"}
_METRIC_METHODS = {"increment_counter", "delta_updown_counter",
                   "record_histogram", "set_gauge"}
# GT001's torch syncs, as methods (JAX's block_until_ready aside)
_SYNC_METHODS = set(BLOCKING_METHODS) - {"block_until_ready"}
_SYNC_DOTTED = {"torch.cuda.synchronize"}
_RANDOM_ROOTS = ("random.", "numpy.random.")
# torch calls that return no tensor (host facts about the device/types)
_TORCH_HOST = {"torch.is_tensor", "torch.cuda.is_available", "torch.device",
               "torch.Size", "torch.finfo", "torch.iinfo",
               "torch.get_default_dtype", "torch.is_grad_enabled",
               "torch.is_floating_point", "torch.cuda.current_device",
               "torch.cuda.current_stream", "torch.cuda.get_device_name"}
# attributes/methods of a tensor that read its structure, not its values
_STRUCTURE = {"shape", "ndim", "dtype", "device", "is_cuda", "numel",
              "dim", "size", "layout", "requires_grad", "is_contiguous",
              "data_ptr", "element_size", "nbytes", "itemsize"}
# value reductions whose truth a Python ``if`` would read
_VALUE_METHODS = {"any", "all", "sum", "max", "min", "eq", "ne", "gt",
                  "lt", "ge", "le", "equal", "allclose", "isnan", "isinf",
                  "isfinite", "count_nonzero", "nonzero"}


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    text = ast.unparse(node)
    return "Tensor" in text and "Optional" not in text


class TracedSideEffectsRule(Rule):
    rule_id = "GT004"
    title = "capture-side-effects (CUDA graph)"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        if not mentions_graphs(module):
            return []
        findings: List[Finding] = []
        for body, name in graph_bodies(module):
            tensors = self._tensors(module, body)
            for node in body_walk(body):
                findings.extend(
                    self._check_node(module, name, node, tensors))
        unique = {}
        for finding in findings:
            unique[(finding.path, finding.line, finding.key)] = finding
        return list(unique.values())

    def _tensors(self, module: ModuleInfo, body: ast.AST) -> Set[str]:
        """Names in ``body`` that hold a tensor (see the module
        docstring)."""
        tensors: Set[str] = set()
        defs = [body] if not isinstance(body, (ast.With, ast.AsyncWith)) \
            else []
        defs += [n for n in body_walk(body)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda))]
        for defn in defs:
            for arg in defn.args.args + defn.args.kwonlyargs:
                if _is_tensor_annotation(arg.annotation):
                    tensors.add(arg.arg)
        for _ in range(2):
            for node in body_walk(body):
                if isinstance(node, ast.Assign) and \
                        self._tensor_valued(module, node.value, tensors):
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            tensors.add(target.id)
        return tensors

    def _tensor_valued(self, module: ModuleInfo, expr: ast.AST,
                       tensors: Set[str]) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in tensors
        if isinstance(expr, ast.BinOp):
            return self._tensor_valued(module, expr.left, tensors) or \
                self._tensor_valued(module, expr.right, tensors)
        if not isinstance(expr, ast.Call):
            return False
        dotted = module.dotted(expr.func)
        if dotted is not None and dotted.startswith("torch.") and \
                dotted not in _TORCH_HOST and dotted not in _SYNC_DOTTED:
            return True
        func = expr.func
        return isinstance(func, ast.Attribute) and \
            func.attr not in _STRUCTURE | _SYNC_METHODS and \
            self._tensor_valued(module, func.value, tensors)

    def _check_node(self, module: ModuleInfo, name: str, node: ast.AST,
                    tensors: Set[str]) -> Iterable[Finding]:
        if isinstance(node, ast.Call):
            hit = self._effect_label(module, node)
            if hit is not None:
                label, why = hit
                return (Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"capture side effect: {label} inside CUDA-graph "
                        f"body '{name}' {why}"),
                    severity=self.severity,
                    key=f"{label} in {name}",
                ),)
        if isinstance(node, (ast.If, ast.IfExp, ast.While)):
            tested = self._tensor_test(module, node.test, tensors)
            if tested is not None:
                return (Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"capture side effect: Python 'if' on the value "
                        f"of tensor '{tested}' in CUDA-graph body "
                        f"'{name}' — it syncs at capture and every replay "
                        f"keeps the branch the capture took; use "
                        f"torch.where or branch on host state"),
                    severity=self.severity,
                    key=f"if {tested} in {name}",
                ),)
        return ()

    def _effect_label(self, module: ModuleInfo, call: ast.Call):
        dotted = module.dotted(call.func)
        if isinstance(call.func, ast.Name) and call.func.id == "print":
            return "print(...)", ("runs once, at capture, not per replay — "
                                  "log at the dispatch site")
        if dotted in _SYNC_DOTTED:
            return f"{dotted}(...)", ("is a host sync: the capture raises "
                                      "(and the eager run under sync "
                                      "debug mode)")
        if dotted is not None and dotted.startswith(_RANDOM_ROOTS):
            return f"{dotted}(...)", ("draws host randomness once, at "
                                      "capture — every replay reuses the "
                                      "draw; use a device generator")
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            receiver = call.func.value
            receiver_name = ""
            if isinstance(receiver, ast.Name):
                receiver_name = receiver.id
            elif isinstance(receiver, ast.Attribute):
                receiver_name = receiver.attr
            if attr in _LOGGER_METHODS and "log" in receiver_name.lower():
                return (f"{receiver_name}.{attr}(...)",
                        "runs once, at capture, not per replay — log at "
                        "the dispatch site")
            if attr in _METRIC_METHODS:
                return (f".{attr}(...)",
                        "counts the capture, not the replays — record "
                        "metrics at the dispatch site")
            if attr in _SYNC_METHODS:
                return (f".{attr}()",
                        "is a device->host sync: the capture raises (and "
                        "the eager run under sync debug mode)")
        return None

    def _tensor_test(self, module: ModuleInfo, test: ast.AST,
                     tensors: Set[str]) -> Optional[str]:
        """Name (or call) of a tensor whose value the test reads, or None
        if the test only inspects structure."""

        def walk_skipping_is(node):
            if isinstance(node, ast.Compare) and \
                    any(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops):
                return
            yield node
            for child in ast.iter_child_nodes(node):
                yield from walk_skipping_is(child)

        for node in walk_skipping_is(test):
            if isinstance(node, ast.Call):
                dotted = module.dotted(node.func)
                if dotted is not None and dotted.startswith("torch.") and \
                        dotted.rpartition(".")[2] in _VALUE_METHODS:
                    return f"{dotted}(...)"
            if not (isinstance(node, ast.Name) and node.id in tensors):
                continue
            parent = module.parents.get(node)
            if isinstance(parent, ast.Attribute) and \
                    parent.attr in _STRUCTURE:
                continue  # x.shape / x.dtype — structure, not values
            if isinstance(parent, ast.Call) and node in parent.args and \
                    isinstance(parent.func, ast.Name) and \
                    parent.func.id in ("len", "isinstance", "getattr",
                                       "hasattr", "type"):
                continue
            return node.id
        return None
