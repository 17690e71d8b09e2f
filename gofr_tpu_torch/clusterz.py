"""Fleet-wide rollup + cross-replica trace stitching: ``/debug/clusterz``
and ``/debug/tracez/{trace_id}`` (the port's copy of
``gofr_tpu/clusterz.py``).

``statusz``/``varz`` describe ONE replica; a
disaggregated fleet needs one page that answers "is the fleet
healthy and where is the hot replica" and one endpoint that reassembles a
request whose flight records live split across a prefill and a decode
replica.

- :func:`build_clusterz` fans out over the :class:`ClusterRegistry`'s
  replicas through their existing transports (InProc probes are plain
  snapshots; HTTP probes ride the circuit-breaker-wrapped service
  client). A replica whose circuit is open is never probed — it is
  marked ``stale`` with the reason, and the page still renders. Probe
  failures likewise degrade to stale entries instead of failing the
  whole page: a half-blind fleet view beats a 500.
- :func:`build_tracez` asks the :class:`DisaggRouter` to stitch the
  end-to-end timeline for one ``trace_id`` (prefill → kv_transfer →
  handoff_gap → decode); when the router has no stitch entry (or
  ``?local=1``) it falls back to this process's own flight records, so
  a replica can always answer for its local half.

Both builders are app-independent (the smoke script and tests call
them without an App); ``enable_clusterz``/``enable_tracez``
are the thin HTTP bindings.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from gofr_tpu_torch.tpu.registry import STATE_DRAINING

__all__ = ["build_clusterz", "build_tracez", "enable_clusterz",
           "enable_tracez"]


def _extract_view(observation: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize one replica's probe result into the rollup fields. An
    InProc probe carries ``stats``/``slo`` directly; an HTTP probe
    carries the peer's whole statusz page."""
    view: Dict[str, Any] = {"goodput_tokens_per_s": None,
                            "pool_occupancy": None,
                            "active_slots": None,
                            "queue_depth": None,
                            "watchdog": None,
                            "device_seconds": None,
                            "max_burn_rate": None,
                            "min_budget_remaining": None,
                            "burning": None}
    statusz = observation.get("statusz") or {}
    slo = observation.get("slo") or statusz.get("slo") or {}
    window = slo.get("60s") or {}
    if "goodput_tokens_per_s" in window:
        view["goodput_tokens_per_s"] = window["goodput_tokens_per_s"]
    stats = observation.get("stats") or {}
    engine = statusz.get("engine") or {}
    kv_pool = stats.get("kv_pool") or engine.get("kv_cache") or {}
    if "occupancy" in kv_pool:
        view["pool_occupancy"] = kv_pool["occupancy"]
    for key in ("active_slots", "queue_depth"):
        if key in stats:
            view[key] = stats[key]
        elif key in engine:
            view[key] = engine[key]
    if statusz.get("watchdog"):
        view["watchdog"] = {
            "state": statusz["watchdog"].get("state"),
            "reason": statusz["watchdog"].get("reason"),
        }
    if stats.get("device_seconds"):
        view["device_seconds"] = stats["device_seconds"]
    # error-budget burn rollup: the replica's statusz already
    # carries its /debug/sloz evaluation — lift the worst burn, the
    # tightest remaining budget, and any burning verdicts into the fleet
    # view so the hot replica is findable without N per-replica fetches
    budget = (observation.get("slo_budget")
              or statusz.get("slo_budget") or {})
    entries = budget.get("budgets") or []
    burns = [b for entry in entries
             for b in (entry.get("burn") or {}).values() if b is not None]
    if burns:
        view["max_burn_rate"] = round(max(burns), 3)
    remaining = [entry["budget_remaining"] for entry in entries
                 if entry.get("budget_remaining") is not None]
    if remaining:
        view["min_budget_remaining"] = min(remaining)
    if budget.get("burning"):
        view["burning"] = list(budget["burning"])
    return view


async def build_clusterz(cluster, router=None,
                         watchdog=None) -> Dict[str, Any]:
    """One fleet snapshot: per-replica health/rollup fields, per-role
    aggregates, and the router's KV-transfer quantiles. Never raises on
    an unreachable replica — it renders ``stale`` instead."""
    replicas: Dict[str, Any] = {}
    for name in cluster.replicas():
        replica = cluster._replicas[name]
        info: Dict[str, Any] = {
            "role": replica.role,
            "state": replica.state,
            "inflight": replica.inflight,
            "requests": replica.requests,
            "transport": getattr(replica.transport, "kind", "?"),
            "stale": False,
        }
        if replica.state == STATE_DRAINING:
            info["drain"] = {"inflight": replica.inflight,
                             "drained": replica.inflight == 0}
        if not replica.transport.available():
            info["stale"] = True
            info["stale_reason"] = "circuit open"
            replicas[name] = info
            continue
        observe = getattr(replica.transport, "observe", None)
        if observe is None:
            info["stale"] = True
            info["stale_reason"] = "transport has no observe()"
            replicas[name] = info
            continue
        try:
            observation = await observe()
        except Exception as exc:
            info["stale"] = True
            info["stale_reason"] = repr(exc)
            replicas[name] = info
            continue
        info["health"] = observation.get("health", "UNKNOWN")
        info.update(_extract_view(observation))
        replicas[name] = info

    roles: Dict[str, Any] = {}
    for role, names in cluster.roles().items():
        fresh = [replicas[n] for n in names if not replicas[n]["stale"]]
        goodput = [r["goodput_tokens_per_s"] for r in fresh
                   if r.get("goodput_tokens_per_s") is not None]
        occupancy = [r["pool_occupancy"] for r in fresh
                     if r.get("pool_occupancy") is not None]
        burn = [r["max_burn_rate"] for r in fresh
                if r.get("max_burn_rate") is not None]
        burning = [n for n in names
                   if not replicas[n]["stale"] and replicas[n].get("burning")]
        roles[role] = {
            "replicas": names,
            "stale": [n for n in names if replicas[n]["stale"]],
            "draining": [n for n in names
                         if replicas[n]["state"] == STATE_DRAINING],
            "goodput_tokens_per_s": (round(sum(goodput), 3)
                                     if goodput else None),
            "max_pool_occupancy": (max(occupancy) if occupancy else None),
            # worst burn across the role's fresh replicas + which
            # replicas have a burning budget pair right now
            "max_burn_rate": (max(burn) if burn else None),
            "burning": burning,
        }

    out: Dict[str, Any] = {
        "at": time.time(),
        "replicas": replicas,
        "roles": roles,
    }
    if router is not None:
        out["router"] = {
            "requests": router._requests,
            "bytes_shipped": router._bytes_shipped,
            "kv_transfer_quantiles": router.transfer_quantiles(),
            "stitched_traces": len(router._stitches),
        }
        # fleet router (tpu/fleet.py): routing split, migrations, and
        # prefix-index coverage ride the same rollup page
        fleet_stats = getattr(router, "fleet_stats", None)
        if fleet_stats is not None:
            out["fleet"] = fleet_stats()
            autoscaler = getattr(router, "autoscaler", None)
            if autoscaler is not None:
                out["fleet"]["autoscaler"] = autoscaler.status()
            # fleet series rollup: the cursor-pulled window
            # means the autoscaler acts on, next to the decision log
            rollup = getattr(router, "rollup", None)
            if rollup is not None:
                out["fleet"]["telemetry"] = rollup.statusz()
    if watchdog is not None:
        out["watchdog"] = watchdog.statusz()
    return out


def _local_records(container, trace_id: str) -> List[Dict[str, Any]]:
    """This process's flight records for ``trace_id`` — engine or
    registry-of-engines, whichever the container wired."""
    tpu = getattr(container, "tpu", None)
    if tpu is None:
        return []
    recorder = getattr(tpu, "recorder", None)
    if recorder is not None:
        return recorder.find(trace_id)
    entries = getattr(tpu, "_entries", None)   # ModelRegistry
    if entries is None:
        return []
    records: List[Dict[str, Any]] = []
    for entry in entries.values():
        recorder = getattr(entry.engine, "recorder", None)
        if recorder is not None:
            records.extend(recorder.find(trace_id))
    return records


async def build_tracez(container, trace_id: str,
                       local_only: bool = False) -> Dict[str, Any]:
    """The stitched timeline when the router has one, the local flight
    records otherwise. ``local_only`` is what a peer's transport asks
    for — it must NOT recurse through the router."""
    router = getattr(container, "cluster_router", None)
    if router is not None and not local_only:
        stitched = await router.trace(trace_id)
        if stitched is not None:
            return stitched
    return {"trace_id": trace_id, "stitched": False,
            "records": _local_records(container, trace_id)}


def enable_clusterz(app, prefix: str = "/debug/clusterz") -> None:
    async def clusterz(ctx):
        container = app.container
        cluster = getattr(container, "cluster", None)
        if cluster is None:
            return {"error": "no cluster registered", "replicas": {}}
        return await build_clusterz(
            cluster,
            router=getattr(container, "cluster_router", None),
            watchdog=getattr(container, "watchdog", None))

    app.get(prefix, clusterz)


def enable_tracez(app, prefix: str = "/debug/tracez") -> None:
    async def tracez(ctx):
        trace_id = ctx.path_param("trace_id")
        local_only = (ctx.param("local") or "") not in ("", "0", "false")
        return await build_tracez(app.container, trace_id,
                                  local_only=local_only)

    app.get(f"{prefix}/{{trace_id}}", tracez)
