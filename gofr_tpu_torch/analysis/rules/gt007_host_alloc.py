"""GT007 hot-path-host-alloc: per-dispatch host copies in dispatch/tick.

The zero-copy data plane exists because ``np.asarray`` +
``np.pad`` per dispatch and per-slot ``float()`` / ``.item()`` syncs in
decode loops were the measured gap between the served path and the
hardware. The staging pool (``gofr_tpu_torch/tpu/staging.py``) kills those
copies; this rule keeps them dead — a fresh host allocation on a
dispatch path is exactly the regression the bench's relay block would
take rounds to re-attribute.

Detection (v2, whole-program): take every function reachable from a
*dispatch root* — a function whose name is
``dispatch``/``_dispatch*``/``dispatch_*``, a tick (``_dispatch_tick``
/ ``_dispatch_spec`` / ``tick`` / ``_tick``), admission
(``_admit_pending``) or the batcher's ``_run`` — along the project call
graph (a staging helper in its own module is still per-dispatch work),
and flag:

- allocating/copying numpy module calls: ``np.asarray``, ``np.array``,
  ``np.pad``, ``np.stack``, ``np.concatenate``, ``np.copy``,
  ``np.ascontiguousarray`` (write into a staging slab instead;
  ``np.zeros``/``np.empty`` are how slabs are *made*, so they pass),
- ``.copy()`` method calls (a fresh host buffer per dispatch),
- per-dispatch host tensors: ``torch.tensor(...)`` (a fresh tensor from
  Python data, and a pageable upload when it names a device),
  ``torch.empty``/``zeros``/``ones``/``full`` with no ``device=`` or a
  ``"cpu"`` one (``pin_memory=True`` passes: that is how a pinned
  staging slab is made), and ``.pin_memory()`` (a fresh pinned copy: a
  page-locking allocation per dispatch),
- per-slot device syncs inside ``for``/``while`` loops: ``.item()``
  and ``float(x[...])`` — ship one packed token array per tick instead
  of one D2H sync per slot.

``jnp.asarray`` resolves to ``jax.numpy`` and is never flagged: device
puts are the data plane's job. Functions *passed* to
``run_in_executor`` get no call edge, so offloaded cold paths are
naturally exempt. Suppress a justified copy with
``# graftcheck: ignore[GT007]`` plus a reason.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

# exact dispatch-root function names (matched on the last qualname
# component, so closures named ``dispatch`` inside admission count)
HOT_ROOT_NAMES = {
    "dispatch", "draft_dispatch", "_admit_pending",
    "_run", "tick", "_tick",
}

# numpy module calls that allocate or copy a host buffer per dispatch
ALLOC_CALLS = {
    "numpy.asarray": "allocates/copies a fresh host array per dispatch",
    "numpy.array": "allocates/copies a fresh host array per dispatch",
    "numpy.pad": "allocates a padded copy per dispatch — write into a "
                 "preallocated staging slab row instead",
    "numpy.stack": "stacks a fresh batch buffer per dispatch — write "
                   "rows into a staging slab instead",
    "numpy.concatenate": "concatenates a fresh buffer per dispatch",
    "numpy.copy": "copies a host buffer per dispatch",
    "numpy.ascontiguousarray": "may copy a host buffer per dispatch",
}


# torch constructors that make a host tensor unless told another device
HOST_TENSOR_CTORS = {"torch.empty", "torch.zeros", "torch.ones",
                     "torch.full"}


def _on_host(call: ast.Call) -> bool:
    """No ``device=`` keyword, or a literal ``"cpu"`` one, and no
    ``pin_memory=True``: a pinned constructor is how a staging slab is
    made (JAX's rule passes ``np.zeros``/``np.empty`` for that reason)."""
    for kw in call.keywords:
        if kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return False
    for kw in call.keywords:
        if kw.arg == "device":
            value = kw.value
            return isinstance(value, ast.Constant) and value.value == "cpu"
    return True


def _is_hot_root(qualname: str) -> bool:
    last = qualname.split(".")[-1]
    return (last in HOT_ROOT_NAMES
            or last.startswith("_dispatch")
            or last.startswith("dispatch_"))


class HostAllocRule(Rule):
    rule_id = "GT007"
    title = "hot-path-host-alloc"
    severity = "error"

    def check_project(self, project) -> Iterable[Finding]:
        roots = [ref for ref in project.functions
                 if _is_hot_root(ref[1])]
        chains = project.reachable(roots)
        findings: List[Finding] = []
        for ref, chain in chains.items():
            module = project.module_of(ref)
            qualname = ref[1]
            for node in project.body_nodes(ref):
                if not isinstance(node, ast.Call):
                    continue
                hit = self._offending(module, node)
                if hit is None:
                    continue
                label, why = hit
                root = project.display(chain[0], module.relpath)
                via = (" via " + " -> ".join(
                    project.display(r, module.relpath)
                    for r in chain[1:])
                    if len(chain) > 1 else "")
                findings.append(Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"hot-path-host-alloc: {label} inside "
                        f"'{qualname}' runs per dispatch (dispatch root "
                        f"'{root}'{via}) — {why}"),
                    severity=self.severity,
                    key=f"{label} in {qualname}",
                ))
        return findings

    # -- per-call classification --------------------------------------------
    def _offending(self, module: ModuleInfo,
                   call: ast.Call) -> Optional[Tuple[str, str]]:
        func = call.func
        dotted = module.dotted(func)
        if dotted is not None and dotted in ALLOC_CALLS:
            return f"{dotted}(...)", ALLOC_CALLS[dotted]
        if isinstance(func, ast.Attribute) and func.attr == "copy":
            return (".copy()",
                    "copies a host buffer per dispatch — reuse a "
                    "staging slab")
        if dotted == "torch.tensor":
            return ("torch.tensor(...)",
                    "builds a fresh tensor from host data per dispatch — "
                    "write into a staging slab instead")
        if dotted in HOST_TENSOR_CTORS and _on_host(call):
            return (f"{dotted}(...) on the host",
                    "allocates a host tensor per dispatch — reuse a "
                    "staging slab")
        if isinstance(func, ast.Attribute) and func.attr == "pin_memory":
            return (".pin_memory()",
                    "page-locks a fresh host buffer per dispatch — "
                    "lease a pinned staging slab instead")
        if self._in_loop(module, call):
            if isinstance(func, ast.Attribute) and func.attr == "item":
                return (".item() in loop",
                        "one device→host sync per slot per tick — "
                        "fetch ONE packed token array instead")
            if isinstance(func, ast.Name) and func.id == "float" and \
                    call.args and isinstance(call.args[0], ast.Subscript):
                return ("float(x[...]) in loop",
                        "one device→host sync per slot per tick — "
                        "fetch ONE packed token array instead")
        return None

    @staticmethod
    def _in_loop(module: ModuleInfo, node: ast.AST) -> bool:
        cursor = module.parents.get(node)
        while cursor is not None:
            if isinstance(cursor, (ast.For, ast.While, ast.AsyncFor)):
                return True
            if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                return False
            cursor = module.parents.get(cursor)
        return False
