"""SLO-class weighted-fair admission queues (counterpart of
``gofr_tpu/tpu/sched.py``, a copy of its code).

Co-resident tenants share one engine's slots and one decode tick, so a
burst of batch traffic must not starve interactive requests that carry
tight deadlines — and an interactive tenant must not monopolize every
admission round just by arriving often. The classic answer is weighted
fair queueing over *virtual time*: each class owns a FIFO; a pop takes
from the non-empty class with the smallest virtual clock, then advances
that clock by ``1 / weight``. A class with weight 4 therefore drains 4
items for every 1 a weight-1 class drains when both are backlogged, yet
an idle class loses nothing (its clock is re-anchored to the current
minimum on first arrival, the standard anti-starvation rule — an empty
class must not bank credit while idle and then lock out everyone else).

Classes are derived from the request deadline (``gofr_tpu_torch/slo.py``):

- ``interactive`` — deadline budget at or under 2 s
  (``DEFAULT_INTERACTIVE_BUDGET_S``); a human is waiting.
- ``standard`` — any other finite deadline.
- ``batch`` — no deadline; throughput traffic.

The same class labels flow through to the engine's overflow deque
(requests admitted past the free-page budget) and its per-class shed
accounting, so one tenant's burst is visible — and sheddable — without
touching another class.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, Optional, Tuple

CLASS_INTERACTIVE = "interactive"
CLASS_STANDARD = "standard"
CLASS_BATCH = "batch"
# Disaggregated serving: requests whose prefill already ran on another
# replica. Their KV pages are on the wire or already resident, so
# stalling them wastes work two replicas performed — decode replicas give
# them the highest default weight.
CLASS_MIGRATED = "migrated"

SLO_CLASSES = (CLASS_INTERACTIVE, CLASS_STANDARD, CLASS_BATCH)

DEFAULT_CLASS_WEIGHTS: Dict[str, float] = {
    CLASS_INTERACTIVE: 4.0,
    CLASS_STANDARD: 2.0,
    CLASS_BATCH: 1.0,
}

# Per-role admission presets (the cluster's replica roles). A prefill replica's
# product is TTFT, so interactive traffic dominates harder than the
# shared default; a decode replica must land migrated KV before anything
# else (see CLASS_MIGRATED); ``both`` is the monolithic default.
ROLE_CLASS_WEIGHTS: Dict[str, Dict[str, float]] = {
    "prefill": {CLASS_INTERACTIVE: 8.0, CLASS_STANDARD: 2.0,
                CLASS_BATCH: 1.0},
    "decode": {CLASS_MIGRATED: 8.0, CLASS_INTERACTIVE: 4.0,
               CLASS_STANDARD: 2.0, CLASS_BATCH: 1.0},
    "both": dict(DEFAULT_CLASS_WEIGHTS),
}


def role_class_weights(role: str,
                       spec: Optional[str] = None) -> Dict[str, float]:
    """Admission weights for a replica role, with an optional
    ``SLO_CLASS_WEIGHTS``-style override spec layered on top (explicit
    operator knobs beat role presets)."""
    weights = dict(ROLE_CLASS_WEIGHTS.get(role, DEFAULT_CLASS_WEIGHTS))
    # only classes the spec names are layered on top — running the spec
    # through parse_class_weights would re-apply the shared defaults and
    # silently undo the role preset for every unmentioned class
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, raw = part.partition(":")
        try:
            weight = float(raw)
        except ValueError:
            continue
        if weight > 0:
            weights[name.strip()] = weight
    return weights

# Deadline budget at or below this is "a human is waiting" traffic.
DEFAULT_INTERACTIVE_BUDGET_S = 2.0


def deadline_class(deadline: Optional[float], now: Optional[float] = None,
                   interactive_budget_s: float = DEFAULT_INTERACTIVE_BUDGET_S
                   ) -> str:
    """Map an absolute monotonic deadline to an SLO class."""
    if deadline is None:
        return CLASS_BATCH
    now = time.monotonic() if now is None else now
    if deadline - now <= interactive_budget_s:
        return CLASS_INTERACTIVE
    return CLASS_STANDARD


# Brownout ladder (the JAX package's ``slo.BrownoutLadder``): which classes a replica sheds
# at each degradation level, ordered by expendability. Level 1 sheds
# batch only; deeper levels also act on speculative decode (engine-side)
# before the watchdog's full shed breaker fires. CLASS_MIGRATED is never
# shed — its prefill work already happened on another replica.
BROWNOUT_SHED = (
    (),                      # level 0: healthy, shed nothing
    (CLASS_BATCH,),          # level 1: throughput traffic waits
    (CLASS_BATCH,),          # level 2: + spec-decode γ capped at 1
    (CLASS_BATCH,),          # level 3: + speculative decode off
)


def brownout_shed_classes(level: int) -> Tuple[str, ...]:
    """Admission classes a replica refuses at brownout ``level``."""
    if level <= 0:
        return BROWNOUT_SHED[0]
    return BROWNOUT_SHED[min(level, len(BROWNOUT_SHED) - 1)]


def parse_class_weights(spec: Optional[str]) -> Dict[str, float]:
    """Parse ``"interactive:4,standard:2,batch:1"`` into a weight map.

    Unknown class names are accepted (forward-compatible with per-tenant
    classes); malformed entries are skipped rather than failing startup —
    a bad knob must never take the replica down. Missing classes fall
    back to the defaults so a partial override stays safe.
    """
    weights = dict(DEFAULT_CLASS_WEIGHTS)
    if not spec:
        return weights
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, _, raw = part.partition(":")
        try:
            weight = float(raw)
        except ValueError:
            continue
        if weight > 0:
            weights[name.strip()] = weight
    return weights


class ClassQueues:
    """Weighted-fair pending queue, API-compatible with the subset of
    ``asyncio.Queue`` the generation engine uses (``put`` / ``get_nowait``
    / ``empty`` / ``qsize``). ``put`` never blocks — admission control
    happens downstream at the free-slot/page-budget gate — but stays a
    coroutine so existing ``await pending.put(...)`` call sites work
    unchanged."""

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = dict(weights or DEFAULT_CLASS_WEIGHTS)
        self._queues: Dict[str, Deque[Any]] = {}
        self._vt: Dict[str, float] = {}
        self._served: Dict[str, int] = {}

    def _weight(self, cls: str) -> float:
        return self._weights.get(cls, 1.0)

    async def put(self, item: Any, cls: str = CLASS_BATCH) -> None:
        self.put_nowait(item, cls)

    def put_nowait(self, item: Any, cls: str = CLASS_BATCH) -> None:
        queue = self._queues.get(cls)
        if queue is None:
            queue = self._queues[cls] = deque()
            self._vt.setdefault(cls, 0.0)
        if not queue:
            # re-anchor: an idle class resumes at the current minimum so
            # it neither banks credit nor starts hopelessly behind
            active = [self._vt[c] for c, q in self._queues.items() if q]
            floor = min(active) if active else 0.0
            self._vt[cls] = max(self._vt.get(cls, 0.0), floor)
        queue.append(item)

    def get_nowait(self) -> Any:
        """Pop from the backlogged class with the smallest virtual time."""
        candidates = [(self._vt[c], c) for c, q in self._queues.items() if q]
        if not candidates:
            raise IndexError("get_nowait() on empty ClassQueues")
        _, cls = min(candidates)
        item = self._queues[cls].popleft()
        self._vt[cls] += 1.0 / self._weight(cls)
        self._served[cls] = self._served.get(cls, 0) + 1
        return item

    def empty(self) -> bool:
        return not any(self._queues.values())

    def qsize(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depths(self) -> Dict[str, int]:
        """Per-class backlog, always including the three standard classes
        (a zero row is a signal too — gauges should not disappear)."""
        out = {cls: 0 for cls in SLO_CLASSES}
        for cls, queue in self._queues.items():
            out[cls] = len(queue)
        return out

    def served(self) -> Dict[str, int]:
        return dict(self._served)

    def weights(self) -> Dict[str, float]:
        return dict(self._weights)

    def set_weights(self, weights: Dict[str, float]) -> None:
        """Atomically replace the per-class weights — the guarded
        operating-point apply path (the JAX engine's
        ``apply_operating_point``). Virtual clocks and
        backlogs are untouched, so already-queued items keep their drain
        order and only *future* pops feel the new shares. Non-positive
        and malformed entries are rejected loudly (unlike the startup
        parser, a runtime retune has a caller to answer to)."""
        cleaned: Dict[str, float] = {}
        for name, raw in weights.items():
            weight = float(raw)
            if weight <= 0:
                raise ValueError(
                    f"class weight {name!r}={raw!r} must be > 0")
            cleaned[str(name)] = weight
        if not cleaned:
            raise ValueError("set_weights: empty weight map")
        self._weights = cleaned

    def drain(self) -> Iterable[Tuple[str, Any]]:
        """Remove and yield every queued ``(cls, item)`` — shutdown path."""
        for cls, queue in self._queues.items():
            while queue:
                yield cls, queue.popleft()


__all__ = [
    "CLASS_INTERACTIVE", "CLASS_STANDARD", "CLASS_BATCH", "CLASS_MIGRATED",
    "SLO_CLASSES", "DEFAULT_CLASS_WEIGHTS", "ROLE_CLASS_WEIGHTS",
    "DEFAULT_INTERACTIVE_BUDGET_S", "deadline_class", "parse_class_weights",
    "role_class_weights", "ClassQueues", "BROWNOUT_SHED",
    "brownout_shed_classes",
]
