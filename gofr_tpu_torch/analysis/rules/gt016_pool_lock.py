"""GT016 shared-pool lock discipline: free-list mutation off the lock.

``PagePool`` (``gofr_tpu_torch/tpu/page_pool.py``) is the one structure in
the serving stack that is *designed* to be touched from two threads:
the engine loop allocates/releases pages while executor threads hold
``pool.lock`` around donating dispatches that read the leaves. The
free-list and refcount tables are plain Python lists/dicts — a
mutation that races a donating dispatch corrupts page accounting
silently: double-allocated pages show up as cross-request KV bleed,
double-freed ones as HBM "leaks" the budget gauge can't explain.

Detection, project-wide:

1. **Find pool classes.** Any class whose constructor binds a
   ``threading.Lock``/``RLock`` to a ``*lock*`` attribute is a
   lock-disciplined shared structure; the attribute name is remembered
   as *the* serializing lock.
2. **Find its mutators.** Methods of that class whose body writes the
   protected tables *outside any* ``with self.<lock>:`` block: an
   assign/augassign/del through ``self.<attr>``, or a mutating method
   call (``append``/``pop``/``remove``/``clear``/…) on one, where
   ``<attr>`` names a free-list or refcount (contains ``free`` or
   ``ref``, or is ``leaves``). A *self-serializing* method — every
   protected mutation under the class's own lock, the ``PagePool``
   idiom — imposes no obligation on callers and is never a mutator.
3. **Flag unlocked mutator calls.** Every call site *outside* the pool
   class whose receiver is pool-typed (project type inference) and
   whose mutator call is not lexically inside ``with <x>.lock:`` — and
   whose enclosing function can actually be *entered* unlocked: a
   function only ever called from inside ``with pool.lock:`` blocks is
   covered by its callers (computed by a worklist over the project
   call graph, starting from functions with no callers).

The pool's own methods are exempt (the class may serialize internally
or document single-writer phases); so are call sites under any
``with *lock*:`` — the checker does not prove it is the *right* lock
(documented blind spot). Suppress a deliberate unlocked phase (e.g.
engine-loop single-writer setup before threads exist) with
``# graftcheck: ignore[GT016]`` plus a justification.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from gofr_tpu_torch.analysis.dataflow import dotted_path
from gofr_tpu_torch.analysis.engine import Finding, Rule

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_MUTATING_CALLS = {
    "append", "pop", "remove", "clear", "extend", "insert", "add",
    "discard", "popitem", "setdefault", "update",
}


def _protected_attr(name: str) -> bool:
    lowered = name.lower()
    return ("free" in lowered or "ref" in lowered
            or lowered in ("leaves", "_leaves"))


def _under_lock(module, node: ast.AST) -> bool:
    """Is ``node`` lexically inside ``with <something lock-ish>:``
    (sync or async) within its own function?"""
    cursor = module.parents.get(node)
    while cursor is not None:
        if isinstance(cursor, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            return False
        if isinstance(cursor, (ast.With, ast.AsyncWith)):
            for item in cursor.items:
                path = dotted_path(item.context_expr)
                if path is not None and _is_lockish(path):
                    return True
        cursor = module.parents.get(cursor)
    return False


def _is_lockish(path: str) -> bool:
    last = path.rsplit(".", 1)[-1].lower()
    return "lock" in last


class PoolLockRule(Rule):
    rule_id = "GT016"
    title = "shared-pool-lock"
    severity = "error"

    def check_project(self, project) -> Iterable[Finding]:
        pools = self._find_pools(project)
        if not pools:
            return []
        mutators = self._find_mutators(project, pools)
        unlocked = self._unlocked_reachable(project)
        findings: List[Finding] = []
        for ref in sorted(project.functions):
            findings.extend(self._check_function(
                project, ref, pools, mutators, unlocked))
        return findings

    # -- step 1: pool classes ----------------------------------------------
    def _find_pools(self, project) -> Dict[Tuple[str, str], str]:
        """ClassRef → lock attribute name."""
        pools: Dict[Tuple[str, str], str] = {}
        for cref, info in project.classes.items():
            init = info.methods.get("__init__")
            if init is None:
                continue
            fn = project.functions.get((cref[0], init))
            if fn is None:
                continue
            module = project.module_of((cref[0], init))
            for node in project.body_nodes((cref[0], init)):
                if not isinstance(node, ast.Assign) \
                        or not isinstance(node.value, ast.Call):
                    continue
                if module.dotted(node.value.func) not in _LOCK_CTORS:
                    continue
                for target in node.targets:
                    path = dotted_path(target)
                    if path and path.startswith("self.") \
                            and _is_lockish(path):
                        pools[cref] = path.split(".", 1)[1]
        return pools

    # -- step 2: mutator methods -------------------------------------------
    def _find_mutators(self, project, pools) -> Dict[
            Tuple[str, str], Set[str]]:
        """ClassRef → method names that mutate protected tables."""
        out: Dict[Tuple[str, str], Set[str]] = {}
        for cref in pools:
            info = project.classes[cref]
            for mname, mqual in info.methods.items():
                if mname == "__init__":
                    continue
                mref = (cref[0], mqual)
                if self._mutates_protected(project, mref):
                    out.setdefault(cref, set()).add(mname)
        return out

    @staticmethod
    def _mutates_protected(project, mref) -> bool:
        """True when the method mutates a protected table *outside* a
        ``with *lock*:`` block — a self-serializing method (all
        mutations internally locked) imposes nothing on callers."""
        module = project.module_of(mref)
        for node in project.body_nodes(mref):
            if _under_lock(module, node):
                continue
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = list(node.targets)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATING_CALLS:
                path = dotted_path(node.func.value)
                if path and path.startswith("self.") and any(
                        _protected_attr(part)
                        for part in path.split(".")[1:]):
                    return True
            for target in targets:
                if isinstance(target, ast.Subscript):
                    target = target.value
                path = dotted_path(target)
                if path and path.startswith("self.") and any(
                        _protected_attr(part)
                        for part in path.split(".")[1:]):
                    return True
        return False

    # -- caller-side lock coverage -----------------------------------------
    def _unlocked_reachable(self, project) -> Set:
        """FuncRefs that can be *entered* without any ``with *lock*:``
        held: entry points (no callers) plus anything called through a
        site that is not under a lock."""
        unlocked: Set = set()
        stack = [ref for ref in project.functions
                 if not project.callers(ref)]
        while stack:
            ref = stack.pop()
            if ref in unlocked:
                continue
            unlocked.add(ref)
            module = project.module_of(ref)
            for callee, site in project.calls(ref):
                if callee in unlocked:
                    continue
                if not _under_lock(module, site):
                    stack.append(callee)
        return unlocked

    # -- step 3: flag unlocked mutator calls --------------------------------
    def _check_function(self, project, ref, pools, mutators,
                        unlocked) -> Iterable[Finding]:
        rel, qualname = ref
        module = project.module_of(ref)
        own_class = project.class_of_function(ref)
        findings: List[Finding] = []
        for node in project.body_nodes(ref):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            rtype = project.type_of(ref, node.func.value)
            if rtype is None or rtype not in pools:
                continue
            if own_class is not None and own_class.ref == rtype:
                continue  # the pool's own methods serialize internally
            if node.func.attr not in mutators.get(rtype, ()):
                continue
            if _under_lock(module, node):
                continue
            if ref not in unlocked:
                continue  # every entry path already holds a lock
            pool_name = project.classes[rtype].name
            receiver = dotted_path(node.func.value) or "<pool>"
            lock_attr = pools[rtype]
            findings.append(Finding(
                rule=self.rule_id, path=module.relpath,
                line=node.lineno,
                message=(
                    f"shared-pool-lock: '{receiver}.{node.func.attr}()' "
                    f"mutates {pool_name}'s free-list/refcount tables "
                    f"without holding '{receiver}.{lock_attr}' — a "
                    f"concurrent donating dispatch in an executor "
                    f"thread races this mutation and corrupts page "
                    f"accounting; wrap the call in "
                    f"'with {receiver}.{lock_attr}:'"),
                severity=self.severity,
                key=(f"unlocked {pool_name}.{node.func.attr} "
                     f"in {qualname}"),
            ))
        return findings
