"""GT001 event-loop-block: blocking calls reachable from ``async def``.

One careless ``block_until_ready()`` / ``.item()`` / ``time.sleep()`` in
an async path stalls every in-flight request — the loop that runs
``DynamicBatcher`` and ``GenerationEngine`` is the only thread accepting
work. Every device wait in the serving stack is hand-offloaded via
``run_in_executor`` (``gofr_tpu_torch/tpu/generate.py`` dispatch/fetch); this
rule makes that discipline machine-checked.

Detection (v2, whole-program): take every function reachable from an
``async def`` along the *project* call graph — through ``from x import
y`` helpers, typed ``self.engine.step()`` receivers, and duck-typed
collaborators, across any number of modules — without a thread hop, and
flag:

- ``time.sleep`` (use ``await asyncio.sleep``),
- ``jax.block_until_ready`` / any ``.block_until_ready()`` method,
- ``jax.device_get`` and ``np.asarray`` / ``np.array`` (device→host
  sync when handed a device value),
- ``.item()`` (scalar device sync),
- torch's device→host syncs: ``.cpu()``, ``.tolist()``, ``.numpy()``
  on a tensor, ``torch.cuda.synchronize()``, and ``.synchronize()`` on
  a ``torch.cuda.Event`` or ``Stream``,
- un-awaited ``.acquire()`` on a lock-named receiver (``await
  lock.acquire()`` on an asyncio lock is fine; a bare call is a
  thread-lock wait). The receiver's name must look like a lock
  (``lock``/``mutex``/``sem``/``cond`` in its last segment) — the
  staging pool's ``acquire()`` is a slab lease, not a wait,
- ``concurrent.futures`` waits (``cf.wait``, dotted ``.result`` on the
  futures module),
- builtin ``open()`` and ``socket.create_connection`` (sync I/O).

Functions *passed* to ``run_in_executor`` / ``asyncio.to_thread`` never
get a call edge, so offloaded work is naturally exempt — even when the
offloaded closure lives two modules away. Suppress a deliberate
host-side use with ``# graftcheck: ignore[GT001]`` plus a justification
comment.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

# fully-dotted callables that block the calling thread
BLOCKING_DOTTED = {
    "time.sleep": "time.sleep() parks the whole event loop — use "
                  "'await asyncio.sleep(...)' or offload",
    "jax.block_until_ready": "jax.block_until_ready() is a device sync",
    "jax.device_get": "jax.device_get() is a device->host sync",
    "numpy.asarray": "np.asarray() on a device value is a device->host "
                     "sync",
    "numpy.array": "np.array() on a device value is a device->host sync",
    "socket.create_connection": "sync socket connect",
    "concurrent.futures.wait": "concurrent.futures.wait() blocks",
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for every "
                              "kernel queued on the device",
}

# method names that block regardless of receiver type
BLOCKING_METHODS = {
    "block_until_ready": "a device sync",
    "item": ".item() synchronously copies a device scalar to host",
    "cpu": ".cpu() of a device tensor is a synchronous device->host copy",
    "tolist": ".tolist() of a device tensor is a device->host sync",
    "numpy": ".numpy() needs a host tensor: on a device value it follows "
             "a device->host sync",
    "synchronize": "Event/Stream.synchronize() waits for the device",
}


class EventLoopBlockRule(Rule):
    rule_id = "GT001"
    title = "event-loop-block"
    severity = "error"

    def check_project(self, project) -> Iterable[Finding]:
        chains = project.reachable(project.async_roots())
        findings: List[Finding] = []
        for ref, chain in chains.items():
            module = project.module_of(ref)
            qualname = ref[1]
            for node in project.body_nodes(ref):
                if not isinstance(node, ast.Call):
                    continue
                hit = self._blocking(module, node)
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
                        f"event-loop-block: {label} inside '{qualname}' "
                        f"runs on the event loop (async root "
                        f"'{root}'{via}) — {why}; offload with "
                        f"run_in_executor/asyncio.to_thread"),
                    severity=self.severity,
                    key=f"{label} in {qualname}",
                ))
        return findings

    def _blocking(self, module: ModuleInfo,
                  call: ast.Call) -> Optional[Tuple[str, str]]:
        func = call.func
        dotted = module.dotted(func)
        if dotted is not None and dotted in BLOCKING_DOTTED:
            return f"{dotted}(...)", BLOCKING_DOTTED[dotted]
        if isinstance(func, ast.Name) and func.id == "open" and \
                "open" not in module.import_aliases:
            return "open(...)", "sync file I/O"
        if isinstance(func, ast.Attribute):
            if func.attr in BLOCKING_METHODS:
                return f".{func.attr}()", BLOCKING_METHODS[func.attr]
            if func.attr == "acquire" and \
                    not isinstance(module.parents.get(call), ast.Await) \
                    and self._lockish_receiver(func.value):
                return (".acquire()",
                        "un-awaited lock acquire blocks the thread "
                        "(asyncio locks are 'await lock.acquire()' / "
                        "'async with lock')")
        return None

    @staticmethod
    def _lockish_receiver(expr: ast.AST) -> bool:
        parts = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if isinstance(expr, ast.Name):
            parts.append(expr.id)
        if not parts:
            return True  # unknown receiver shape: keep the old behavior
        last = parts[0].lower()
        return any(tok in last for tok in ("lock", "mutex", "sem", "cond"))
