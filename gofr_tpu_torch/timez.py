"""Time-series telemetry over HTTP: ``/debug/timez`` (the port's copy of
``gofr_tpu/timez.py``).

The history twin of ``/debug/varz``: where varz answers *how well is
the replica doing right now*, timez answers *how did it get here* —
aligned multi-resolution series (1s/10s/60s tiers) for every registered
signal, active and recent anomalies from the change-point detector,
the sampled decode-tick anatomy ring, and the store's memory contract.

Query parameters:

- ``tier=1s|10s|60s`` — which resolution to render (default ``10s``).
- ``signals=a,b,c``   — restrict the series payload to named signals.
- ``limit=N``         — newest N buckets per signal (default all held).
- ``cursor=N``        — switch to the cursor-delta payload instead of
  the bucketed series: raw samples after sequence ``N``, bounded — the
  fleet rollup's pull path (``cursor=0`` starts a fresh pull).

Registered like the other debug surfaces — ``app.enable_timez()`` —
never on by default. Every answer is a snapshot over bounded rings;
nothing here touches the device.
"""

from __future__ import annotations

from typing import Any, Dict


def build_timez(app, tier: str = "10s", signals=None,
                limit=None, cursor=None) -> Dict[str, Any]:
    container = app.container
    store = getattr(container, "telemetry", None)
    out: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
    }
    if store is None:
        out["telemetry"] = None
        return out
    if cursor is not None:
        # fleet pull path: raw sample deltas, not bucketed series
        out["delta"] = store.delta(cursor)
        return out
    out["signals"] = store.signals()
    out["series"] = store.series(tier=tier, signals=signals, limit=limit)
    out["anomalies"] = store.anomalies()
    out["ticks"] = store.tick_anatomy()
    out["memory"] = store.memory_info()
    out["sparklines"] = store.sparklines(tier=tier)
    return out


def enable_timez(app, prefix: str = "/debug/timez") -> None:
    def timez(ctx):
        tier = ctx.param("tier") or "10s"
        raw_signals = ctx.param("signals")
        signals = [s for s in raw_signals.split(",") if s] \
            if raw_signals else None
        try:
            limit = int(ctx.param("limit")) if ctx.param("limit") else None
        except (TypeError, ValueError):
            limit = None
        cursor = None
        raw_cursor = ctx.param("cursor")
        if raw_cursor not in (None, ""):
            try:
                cursor = int(raw_cursor)
            except (TypeError, ValueError):
                cursor = None
        try:
            return build_timez(app, tier=tier, signals=signals,
                               limit=limit, cursor=cursor)
        except ValueError as exc:   # unknown tier -> a readable answer
            return {"error": str(exc)}

    app.get(prefix, timez)
