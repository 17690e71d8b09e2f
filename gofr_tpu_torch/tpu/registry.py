"""Multi-model registry: named engines, lifecycle, SLO-aware routing (a
copy of ``gofr_tpu/tpu/registry.py``, over the port's engines).

The tenancy layer. One replica serves several named model
instances — a big target, its speculative draft, a cheap fallback, an
MoE variant — and the registry owns everything above a single engine:

- **Lifecycle**: ``LOADING → WARMING → READY → DRAINING → UNLOADED``,
  driven by ``register``/``warmup``/``start``/``drain``/``unload``.
  Routing only ever hands out READY engines; draining models finish
  their in-flight work but take no new requests.
- **Routing**: ``route(name)`` resolves a model name to its engine, with
  ONE hop of fallback — when the entry is not READY, or the container
  watchdog reports ``DEGRADED`` and the entry names a cheaper fallback,
  traffic shifts to the fallback model (counted per edge in
  ``app_tpu_model_fallback_total{model,to}``). Fallback is deliberately
  not transitive: a chain of degraded models should fail loudly, not
  cascade silently.
- **Shared HBM**: co-resident engines with the same KV geometry pass one
  literal :class:`~gofr_tpu_torch.tpu.page_pool.PagePool` instance (page ids
  interchangeable, occupancy chip-global); heterogeneous models carve
  byte budgets from one :class:`~gofr_tpu_torch.tpu.page_pool.HBMBudget`
  instead. The registry validates neither — the pool/budget constructors
  already fail at load, not mid-traffic — it just surfaces both in
  ``stats()``.

The registry duck-types the engine observability contract
(``stats``/``statusz``/``xlaz``/``health_check``) so it slots into
``container.tpu`` and the /debug pages unchanged; its sections are keyed
by model name with the default model mirrored under the legacy
single-model keys.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional

from gofr_tpu_torch.slo import STATE_DEGRADED

STATE_LOADING = "LOADING"
STATE_WARMING = "WARMING"
STATE_READY = "READY"
STATE_DRAINING = "DRAINING"
STATE_UNLOADED = "UNLOADED"

# gauge encoding for app_tpu_model_state{model} — dashboards alert on
# value < 2 (not serving) and value == 3 (draining)
_STATE_GAUGE = {
    STATE_LOADING: 0.0,
    STATE_WARMING: 1.0,
    STATE_READY: 2.0,
    STATE_DRAINING: 3.0,
    STATE_UNLOADED: 4.0,
}


class ModelUnavailable(RuntimeError):
    """Raised by ``route`` when the named model cannot serve and no READY
    fallback exists. Carries 503 semantics for the HTTP layer."""

    status_code = 503

    def __init__(self, name: str, state: str):
        super().__init__(
            f"model {name!r} is {state} and has no READY fallback")
        self.model = name
        self.state = state


class _Entry:
    __slots__ = ("name", "engine", "state", "fallback", "loaded_at",
                 "role")

    def __init__(self, name: str, engine: Any, fallback: Optional[str],
                 role: str = "both"):
        self.name = name
        self.engine = engine
        self.state = STATE_LOADING
        self.fallback = fallback
        self.loaded_at = time.monotonic()
        # disaggregated serving: which phase this entry serves
        # ("prefill" | "decode" | "both") — observability keying only;
        # routing between roles is tpu/cluster.py's job
        self.role = role


class ModelRegistry:
    """Named model instances behind one routing/lifecycle front."""

    def __init__(self, watchdog=None, hbm_budget=None, page_pool=None,
                 logger=None, metrics=None):
        self.watchdog = watchdog
        self.hbm_budget = hbm_budget
        self.page_pool = page_pool
        self.logger = logger
        self.metrics = metrics
        self._entries: Dict[str, _Entry] = {}
        self._default: Optional[str] = None
        self._fallbacks_taken: Dict[tuple, int] = {}

    # -- lifecycle ----------------------------------------------------------
    def register(self, name: str, engine: Any,
                 fallback: Optional[str] = None,
                 default: bool = False, role: str = "both") -> _Entry:
        """Add a named engine in LOADING state. The first registration
        (or ``default=True``) becomes the unnamed-route default.
        ``fallback`` names the model DEGRADED/unavailable traffic shifts
        to — it may be registered later; resolution happens per-route.
        ``role`` tags the entry's serving phase for the disaggregated
        topology (prefill/decode/both) so /debug pages key per role."""
        name = str(name)
        if name in self._entries:
            raise ValueError(f"model {name!r} is already registered")
        if fallback == name:
            raise ValueError(f"model {name!r} cannot fall back to itself")
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"model {name!r} role {role!r}: expected prefill, "
                "decode, or both")
        entry = _Entry(name, engine, fallback, role)
        self._entries[name] = entry
        if default or self._default is None:
            self._default = name
        self._set_state(entry, STATE_LOADING)
        if self.logger is not None:
            self.logger.info(
                "registry: registered model %r (fallback=%r, role=%s)",
                name, fallback, role)
        return entry

    async def warmup(self, name: str, **kwargs) -> None:
        """WARMING → READY: run the engine's warmup (compiles the serving
        executables off the hot path). A warmup failure leaves the entry
        in WARMING — visibly not serving — rather than half-READY."""
        entry = self._require(name)
        self._set_state(entry, STATE_WARMING)
        await entry.engine.warmup(**kwargs)
        self._set_state(entry, STATE_READY)

    async def start(self, name: Optional[str] = None) -> None:
        """Start one engine loop (or every registered one). Engines whose
        warmup was skipped move straight to READY — lazily compiling on
        the first request is allowed, just not free."""
        names = [name] if name is not None else list(self._entries)
        for entry_name in names:
            entry = self._require(entry_name)
            await entry.engine.start()
            if entry.state in (STATE_LOADING, STATE_WARMING):
                self._set_state(entry, STATE_READY)

    async def drain(self, name: str, timeout_s: float = 30.0,
                    poll_s: float = 0.05) -> bool:
        """READY → DRAINING: stop routing new work to the model, then wait
        for its in-flight slots and admission backlog to empty. Returns
        True when fully drained within the timeout (the entry stays
        DRAINING either way — ``unload`` is the exit)."""
        entry = self._require(name)
        self._set_state(entry, STATE_DRAINING)
        deadline = time.monotonic() + timeout_s
        engine = entry.engine
        while time.monotonic() < deadline:
            busy = getattr(engine, "active_slots", 0)
            pending = getattr(engine, "_pending", None)
            if not busy and (pending is None or pending.empty()):
                return True
            await asyncio.sleep(poll_s)
        return False

    async def unload(self, name: str) -> None:
        """Stop the engine loop and retire the entry. A byte carve held in
        the HBM budget under this model's name is released so the next
        load can claim it."""
        entry = self._require(name)
        await entry.engine.stop()
        self._set_state(entry, STATE_UNLOADED)
        if self.hbm_budget is not None:
            self.hbm_budget.release(name)

    async def stop(self) -> None:
        """Stop every engine (container shutdown path)."""
        for entry in self._entries.values():
            if entry.state != STATE_UNLOADED:
                await entry.engine.stop()

    def _require(self, name: str) -> _Entry:
        entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{sorted(self._entries)}")
        return entry

    def _set_state(self, entry: _Entry, state: str) -> None:
        entry.state = state
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_model_state",
                                   _STATE_GAUGE[state], model=entry.name)

    # -- routing ------------------------------------------------------------
    def models(self) -> List[str]:
        return sorted(self._entries)

    def engine(self, name: Optional[str] = None):
        """The named (default when None) entry's engine, regardless of
        lifecycle state — the admin/warmup path. Traffic uses ``route``."""
        name = name or self._default
        if name is None:
            raise ModelUnavailable("<none>", "unregistered")
        return self._require(name).engine

    @property
    def default_model(self) -> Optional[str]:
        return self._default

    def route(self, name: Optional[str] = None):
        """Resolve ``name`` (default model when None) to a servable
        engine. One fallback hop: a non-READY entry, or a READY entry
        under a DEGRADED watchdog, shifts to its configured fallback when
        that fallback is READY. No READY candidate → ModelUnavailable."""
        name = name or self._default
        if name is None:
            raise ModelUnavailable("<none>", "unregistered")
        entry = self._require(name)
        degraded = (self.watchdog is not None
                    and getattr(self.watchdog, "state", None)
                    == STATE_DEGRADED)
        if entry.state == STATE_READY and not degraded:
            return entry.engine
        fallback = (self._entries.get(entry.fallback)
                    if entry.fallback else None)
        if fallback is not None and fallback.state == STATE_READY:
            self._fallbacks_taken[(name, fallback.name)] = \
                self._fallbacks_taken.get((name, fallback.name), 0) + 1
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_tpu_model_fallback_total", model=name,
                    to=fallback.name)
            if self.logger is not None:
                self.logger.warn(
                    "registry: routed %r -> %r (%s%s)", name, fallback.name,
                    entry.state,
                    ", watchdog DEGRADED" if degraded else "")
            return fallback.engine
        if entry.state == STATE_READY:
            # degraded but nothing cheaper to shift to: keep serving —
            # shedding a READY model because its fallback is absent would
            # turn a brown-out into an outage
            return entry.engine
        raise ModelUnavailable(name, entry.state)

    # -- observability (engine duck-type contract) --------------------------
    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "default": self._default,
            "models": {
                name: {
                    "state": entry.state,
                    "role": entry.role,
                    "fallback": entry.fallback,
                    "stats": entry.engine.stats(),
                }
                for name, entry in self._entries.items()
            },
            "fallbacks_taken": {
                f"{src}->{dst}": count
                for (src, dst), count in self._fallbacks_taken.items()
            },
        }
        if self.hbm_budget is not None:
            out["hbm_budget"] = self.hbm_budget.stats()
        if self.page_pool is not None:
            out["shared_pool"] = self.page_pool.stats()
        return out

    def statusz(self, recent: int = 32) -> Dict[str, Any]:
        out = {
            "default": self._default,
            "models": {
                name: dict(entry.engine.statusz(recent=recent),
                           state=entry.state, role=entry.role,
                           fallback=entry.fallback)
                for name, entry in self._entries.items()
                if entry.state != STATE_UNLOADED
            },
            "fallbacks_taken": {
                f"{src}->{dst}": count
                for (src, dst), count in self._fallbacks_taken.items()
            },
        }
        if self.page_pool is not None:
            # chip-global view of the shared tenancy; the per-model split
            # is each entry's own kv_cache block above
            out["shared_pool"] = self.page_pool.stats()
        return out

    def hbm_attribution(self) -> Dict[str, Any]:
        """Fleet-of-models HBM attribution: per-model params +
        pool + staging figures merged into one page, with a SHARED page
        pool counted exactly once (each co-resident engine reports the
        same pool object; double-counting it would fabricate HBM). The
        budget's carve-vs-actual table rides along when carves exist."""
        models: Dict[str, Any] = {}
        attributed = 0
        pools_seen: set = set()
        device_bytes = None
        for name, entry in self._entries.items():
            engine = entry.engine
            attribution = getattr(engine, "hbm_attribution", None)
            if attribution is None:
                continue
            report = attribution()
            models[name] = report
            attributed += report["params_bytes"]
            attributed += report["staging_bytes"]
            pool = getattr(engine, "_pool", None)
            if report.get("page_pool") and pool is not None \
                    and id(pool) not in pools_seen:
                pools_seen.add(id(pool))
                attributed += report["page_pool"]["pool_bytes"]
            if device_bytes is None:
                device_bytes = report.get("device_bytes_in_use")
        out: Dict[str, Any] = {
            "models": models,
            "attributed_bytes": attributed,
            "device_bytes_in_use": device_bytes,
            "unattributed_bytes": (device_bytes - attributed
                                   if device_bytes is not None else None),
        }
        if self.hbm_budget is not None:
            budget = self.hbm_budget.stats()
            out["hbm_budget"] = budget
            # carve-vs-actual: what each model reserved at registration
            # vs what its engine attributes right now
            out["carve_vs_actual"] = {
                name: {"carved_bytes": carved,
                       "actual_bytes": (
                           models[name]["params_bytes"]
                           + models[name]["staging_bytes"]
                           + ((models[name].get("page_pool") or {})
                              .get("pool_bytes", 0))
                           if name in models else None)}
                for name, carved in budget.get("carves", {}).items()}
        return out

    def xlaz(self, recent: int = 64) -> Dict[str, Any]:
        # keyed "engines" (not "models"): each engine's own xlaz already
        # uses a "models" key for its shape ladders
        return {
            "engines": {
                name: entry.engine.xlaz(recent=recent)
                for name, entry in self._entries.items()
                if entry.state != STATE_UNLOADED
            },
        }

    def health_check(self) -> Dict[str, Any]:
        details: Dict[str, Any] = {"default": self._default, "models": {}}
        status = "UP"
        for name, entry in self._entries.items():
            health = entry.engine.health_check()
            details["models"][name] = {
                "state": entry.state,
                "role": entry.role,
                "engine": health["status"],
            }
            # an UNLOADED/LOADING model is not a failure; a READY model
            # whose engine reports DOWN is
            if entry.state == STATE_READY and health["status"] != "UP":
                status = "DOWN"
        if not any(entry.state == STATE_READY
                   for entry in self._entries.values()):
            status = "DOWN"
        return {"status": status, "details": details}


__all__ = [
    "ModelRegistry", "ModelUnavailable",
    "STATE_LOADING", "STATE_WARMING", "STATE_READY", "STATE_DRAINING",
    "STATE_UNLOADED",
]
