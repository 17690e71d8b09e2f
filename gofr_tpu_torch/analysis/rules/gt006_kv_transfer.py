"""GT006 kv-transfer-sync: KV pool leaves materialized on the event loop.

Disaggregated serving moves whole prompts' KV between
replicas, and the tempting implementation is exactly the wrong one:
``np.asarray(pool.leaves["k"])`` / ``jax.device_get(...)`` inline in an
async handler. A KV handoff is megabytes per request — a 7B prompt's
pages are tens of MB — so one sync device→host copy on the loop stalls
*every* co-resident request for the duration of a PCIe/ICI transfer,
not the microseconds GT001's generic ``.item()`` case suggests. The
same goes for :mod:`~gofr_tpu_torch.tpu.kv_wire` ``pack``/``unpack`` called
inline: both walk every leaf buffer (``tobytes``/``frombuffer``) and
are pure host CPU burn.

GT001 already flags bare ``np.asarray`` in async-reachable code; this
rule exists because KV-leaf materialization deserves its own id and
message — the fix (stage through ``run_in_executor`` like the engine's
``prefill_export``/``adopt_kv`` closures) and the blast radius (all
in-flight streams, per transfer) are specific, and a baseline that
waives generic GT001 hits must not silently waive multi-megabyte KV
copies with them.

Detection, over functions reachable from an ``async def`` without a
thread hop (callgraph ``loop_reachable``; executor-passed callables get
no edge and are naturally exempt):

- ``jax.device_get`` / ``np.asarray`` / ``np.array`` whose argument
  references KV pool leaves — an attribute access ending in ``.leaves``
  or a name/attribute containing ``pool``,
- ``.tobytes()`` on such a leaf expression (the serialization copy),
- any call resolving to ``kv_wire.pack`` / ``kv_wire.unpack``,
- torch's device→host syncs (GT001's list) on such a leaf expression:
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``.item()``,
- and, in the KV export and adopt modules (``tpu/kv_wire.py``,
  ``tpu/cluster.py``), every one of GT001's torch syncs, whatever its
  argument: ``torch.cuda.synchronize()``, ``Event``/``Stream``
  ``.synchronize()`` and the tensor methods above.

Suppress a deliberate inline use with ``# graftcheck: ignore[GT006]``
plus a justification.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from gofr_tpu_torch.analysis.callgraph import CallGraph
from gofr_tpu_torch.analysis.engine import Finding, ModuleInfo, Rule

# device→host materializers: flagged only when fed a KV-leaf expression
MATERIALIZERS = {"jax.device_get", "numpy.asarray", "numpy.array"}

# kv_wire entry points that walk every leaf buffer on the calling thread
_WIRE_SUFFIXES = ("kv_wire.pack", "kv_wire.unpack")

# torch's device->host syncs, as tensor methods (GT001's list)
SYNC_METHODS = {"cpu", "tolist", "numpy", "item"}

# the KV export and adopt modules, where every torch sync is a KV one
KV_MODULES = ("tpu/kv_wire.py", "tpu/cluster.py")


def _mentions_pool_leaves(node: ast.AST) -> bool:
    """Does this expression reference KV pool leaves? Matches attribute
    chains ending in ``.leaves`` (``pool.leaves``, ``self._pool.leaves``,
    ``payload.leaves``) and names/attributes containing ``pool``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            if sub.attr == "leaves" or "pool" in sub.attr:
                return True
        elif isinstance(sub, ast.Name) and "pool" in sub.id:
            return True
    return False


class KVTransferSyncRule(Rule):
    rule_id = "GT006"
    title = "kv-transfer-sync"
    severity = "error"

    def check_module(self, module: ModuleInfo) -> Iterable[Finding]:
        graph = CallGraph(module)
        chains = graph.loop_reachable()
        findings: List[Finding] = []
        for qualname, chain in chains.items():
            fn = graph.functions[qualname]
            for node in graph.body_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                hit = self._kv_sync(module, node)
                if hit is None:
                    continue
                label, why = hit
                via = (" via " + " -> ".join(chain[1:])
                       if len(chain) > 1 else "")
                findings.append(Finding(
                    rule=self.rule_id,
                    path=module.relpath,
                    line=node.lineno,
                    message=(
                        f"kv-transfer-sync: {label} inside '{qualname}' "
                        f"materializes KV pool leaves on the event loop "
                        f"(async root '{chain[0]}'{via}) — {why}; stage "
                        f"the copy in a run_in_executor closure like the "
                        f"engine's prefill_export/adopt_kv paths"),
                    severity=self.severity,
                    key=f"{label} in {qualname}",
                ))
        return findings

    def _kv_sync(self, module: ModuleInfo,
                 call: ast.Call) -> Optional[Tuple[str, str]]:
        dotted = module.dotted(call.func)
        if dotted is not None:
            for suffix in _WIRE_SUFFIXES:
                if dotted == suffix or dotted.endswith("." + suffix):
                    return (f"{suffix}(...)",
                            "serializing KV leaves walks every page "
                            "buffer on the calling thread")
            if dotted in MATERIALIZERS and call.args and \
                    _mentions_pool_leaves(call.args[0]):
                return (f"{dotted}(...) on pool leaves",
                        "a whole prompt's KV pages cross device->host "
                        "synchronously (megabytes per request)")
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr == "tobytes" \
                and _mentions_pool_leaves(func.value):
            return (".tobytes() on pool leaves",
                    "the serialization copy of every KV page runs on "
                    "the calling thread")
        if isinstance(func, ast.Attribute) and func.attr in SYNC_METHODS \
                and _mentions_pool_leaves(func.value):
            return (f".{func.attr}() on pool leaves",
                    "a whole prompt's KV pages cross device->host "
                    "synchronously (megabytes per request)")
        if module.relpath.endswith(KV_MODULES):
            if dotted == "torch.cuda.synchronize" or (
                    isinstance(func, ast.Attribute) and func.attr in
                    SYNC_METHODS | {"synchronize"}):
                label = (f"{dotted}(...)" if dotted == "torch.cuda."
                         "synchronize" else f".{func.attr}()")
                return (f"{label} on the KV path",
                        "a device sync on the KV export/adopt path waits "
                        "for the transfer on the calling thread")
        return None
