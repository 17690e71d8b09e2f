"""Deterministic, seeded fault-injection plane (a copy of
``gofr_tpu/tpu/faults.py``; the port's engine carries the
``tick_exception`` and ``nan_logits`` sites).

The chaos plane turns the fleet's implicit failure behavior into tested
contracts: every layer that can fail in production (KV wire, transports,
replica crash-at-phase, engine ticks, the batch broker) carries a named
injection *site*, and a ``FaultPlan`` decides — deterministically, from a
seed — whether a given arrival at a site fires.

Plan specs are environment-configurable via ``FAULT_PLAN``::

    FAULT_PLAN="seed=7,crash_mid_decode:@2,kv_chunk_truncate:0.25"

Entry grammar (comma separated):

- ``seed=N``          — seed for the plan RNG (default 0).
- ``site``            — fire on EVERY arrival at ``site``.
- ``site:0.25``       — fire with probability 0.25 per arrival, drawn
  from the seeded RNG (deterministic across runs for a fixed seed and
  arrival order).
- ``site:@3``         — fire exactly once, on the 3rd arrival at
  ``site`` (1-based); subsequent arrivals pass.

Known sites (threaded through the serving layers):

==================== =====================================================
site                 where it fires
==================== =====================================================
kv_chunk_truncate    kv_wire.iter_chunks — short final chunk on the wire
kv_chunk_corrupt     kv_wire.iter_chunks — flipped byte inside a chunk
transport_prefill    InProcTransport.prefill — replica dies post-prefill
crash_mid_transfer   InProcTransport.adopt — dies mid-KV-transfer
crash_mid_decode     fleet relay — decode replica dies mid-stream
crash_mid_migration  FleetRouter.migrate_session — dies mid-export
tick_exception       GenerationEngine._dispatch_tick — tick raises
nan_logits           GenerationEngine._publish — poisoned slot tokens
broker_drop          BatchLane._publish — broker write fails
==================== =====================================================

Hot-path contract: when no plan is installed the module-level singleton
is a no-op whose ``enabled`` attribute is False and whose ``should()``
returns False without allocating — disabled cost is one attribute load
plus a bool test. Install a plan only in tests, smoke scripts, and the
chaos bench.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional, Tuple

from gofr_tpu_torch.trace.tracer import current_span

__all__ = [
    "FaultError",
    "FaultPlan",
    "active",
    "install",
    "plan_from_env",
    "reset",
]


class FaultError(RuntimeError):
    """Raised by an injection site when the plan says to fire.

    Carries ``site`` so recovery paths and tests can tell injected
    failures apart from organic ones.
    """

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


class FaultPlan:
    """Seeded, deterministic decision table over named injection sites.

    ``should(site)`` counts the arrival and answers whether this arrival
    fires. Decisions are reproducible for a fixed (seed, arrival order):
    probabilistic entries consume the plan RNG only on their own
    arrivals, so unrelated sites do not perturb each other's draws.
    """

    enabled = True

    def __init__(self, spec: str = "", *, seed: int = 0, metrics=None):
        self._rng = random.Random(seed)
        self.seed = seed
        self.metrics = metrics
        self._lock = threading.Lock()
        # site -> (mode, value); mode is "always" | "prob" | "nth"
        self._sites: Dict[str, Tuple[str, float]] = {}
        self._arrivals: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                self.seed = int(entry[5:])
                self._rng = random.Random(self.seed)
                continue
            if ":" in entry:
                site, arg = entry.split(":", 1)
                site = site.strip()
                arg = arg.strip()
                if arg.startswith("@"):
                    self._sites[site] = ("nth", float(int(arg[1:])))
                else:
                    self._sites[site] = ("prob", float(arg))
            else:
                self._sites[entry] = ("always", 1.0)

    def arm(self, site: str, *, prob: Optional[float] = None,
            nth: Optional[int] = None) -> "FaultPlan":
        """Programmatic equivalent of a spec entry (tests, bench)."""
        if nth is not None:
            self._sites[site] = ("nth", float(nth))
        elif prob is not None:
            self._sites[site] = ("prob", float(prob))
        else:
            self._sites[site] = ("always", 1.0)
        return self

    def disarm(self, site: str) -> None:
        self._sites.pop(site, None)

    def should(self, site: str) -> bool:
        """Count one arrival at ``site``; True when this arrival fires."""
        entry = self._sites.get(site)
        if entry is None:
            return False
        with self._lock:
            n = self._arrivals.get(site, 0) + 1
            self._arrivals[site] = n
            mode, value = entry
            if mode == "always":
                fire = True
            elif mode == "nth":
                fire = n == int(value)
            else:
                fire = self._rng.random() < value
            if fire:
                self._fired[site] = self._fired.get(site, 0) + 1
        if fire:
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_tpu_fault_injected_total", site=site)
            # chaos-plane trace visibility: the injection
            # stamps the surrounding span, so a tracez/chaos trace shows
            # WHY a phase stalled — which site fired, at what arrival
            span = current_span()
            if span is not None:
                span.add_event("fault.injected", site=site, arrival=n)
        return fire

    def raise_if(self, site: str) -> None:
        """``should`` + raise, for sites whose failure mode is an error."""
        if self.should(site):
            raise FaultError(site)

    def fired(self, site: Optional[str] = None):
        """Injection counts — one site's, or the full dict."""
        with self._lock:
            if site is not None:
                return self._fired.get(site, 0)
            return dict(self._fired)

    def arrivals(self, site: str) -> int:
        with self._lock:
            return self._arrivals.get(site, 0)


class _NoopPlan:
    """Disabled plane: one attr load + bool test, no allocation."""

    enabled = False

    def should(self, site: str) -> bool:
        return False

    def raise_if(self, site: str) -> None:
        return None

    def fired(self, site: Optional[str] = None):
        return 0 if site is not None else {}

    def arrivals(self, site: str) -> int:
        return 0


_NOOP = _NoopPlan()
_active = _NOOP


def active():
    """The installed plan, or the no-op singleton when chaos is off."""
    return _active


def install(plan: Optional[FaultPlan]):
    """Install ``plan`` as the active plan (None restores the no-op)."""
    global _active
    _active = plan if plan is not None else _NOOP
    return _active


def reset() -> None:
    """Restore the disabled no-op singleton."""
    global _active
    _active = _NOOP


def plan_from_env(environ=os.environ, metrics=None) -> Optional[FaultPlan]:
    """Build a plan from ``FAULT_PLAN``; None when unset/empty."""
    spec = environ.get("FAULT_PLAN", "").strip()
    if not spec:
        return None
    return FaultPlan(spec, metrics=metrics)
