"""graftcheck: serving-aware static analysis for the gofr_tpu_torch tree.

Run it as ``python -m gofr_tpu_torch.analysis``: it scans the port's
package with the committed baseline ``scripts/graftcheck_torch_baseline.json``
(empty) and exits 0 when nothing new is found. Importing it loads neither
``torch`` nor anything of the JAX package. Rule catalog and suppression
syntax: ``docs/references/static-analysis-torch.md``.

Rules keep the JAX package's ids, so a pragma means the same thing in
both trees:

- **GT001 event-loop-block** — blocking calls (``time.sleep``, torch's
  device→host syncs, sync I/O, thread-lock acquires) reachable from an
  ``async def`` without a ``run_in_executor``/``to_thread`` hop.
- **GT002 fire-and-forget-task** — ``ensure_future``/``create_task``
  results dropped with no exception-handling done-callback; use
  :func:`gofr_tpu_torch.aio.spawn_logged`.
- **GT003 recapture-hazard** — CUDA graphs captured per call, graph-table
  keys and capture shapes taken from unrounded lengths.
- **GT004 capture-side-effects** — logging, metrics, host syncs, host
  randomness and tensor-valued ``if`` inside CUDA-graph bodies.
- **GT005 metric-discipline** — the metric-name + docs-drift lint, with
  names registered through a catalog table counted.
- **GT015 static-output-reuse** — a graph's static output read after the
  next replay overwrote it.

``docs/references/static-analysis-torch.md`` has every rule.
"""

from gofr_tpu_torch.analysis.engine import (
    DEFAULT_BASELINE,
    DEFAULT_CACHE,
    Finding,
    ModuleInfo,
    PACKAGE,
    ROOT,
    Report,
    Rule,
    audit_pragmas,
    load_baseline,
    run,
    write_baseline,
)
from gofr_tpu_torch.analysis.rules import ALL_RULES, default_rules

__all__ = [
    "ALL_RULES",
    "DEFAULT_BASELINE",
    "DEFAULT_CACHE",
    "Finding",
    "ModuleInfo",
    "PACKAGE",
    "ROOT",
    "Report",
    "Rule",
    "audit_pragmas",
    "default_rules",
    "load_baseline",
    "run",
    "write_baseline",
]
