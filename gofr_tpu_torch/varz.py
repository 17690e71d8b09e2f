"""SLO & saturation snapshot over HTTP: ``/debug/varz`` (the port's copy
of ``gofr_tpu/varz.py``).

The numeric twin of ``/debug/statusz``: where statusz shows
*what the server is doing* (slots, queues, request timelines), varz shows
*how well it is doing it* — windowed TTFT quantiles (p50/p95/p99 over
1m/5m from the bounded digest, metrics/digest.py), raw vs goodput
tokens/s, deadline-outcome counts and SLO attainment, device duty cycle /
MFU / HBM occupancy, and the degradation watchdog's state machine.

JSON rather than Prometheus text so operators (and the acceptance tests)
can read exact windowed values without scrape-interval aliasing.
Registered like statusz — ``app.enable_varz()`` — never on by default.
Host-side bookkeeping only; the caching allocator's statistics are the
one device figure and reading them does not sync the stream.
"""

from __future__ import annotations

from typing import Any, Dict


def build_varz(app) -> Dict[str, Any]:
    container = app.container
    varz: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
    }

    slo = getattr(container, "slo", None)
    if slo is not None:
        varz["slo"] = slo.snapshot()
        slo.export_gauges()   # keep /metrics gauges aligned with this view

    watchdog = getattr(container, "watchdog", None)
    if watchdog is not None:
        varz["watchdog"] = watchdog.statusz()

    tpu = container.tpu
    if tpu is not None and hasattr(tpu, "saturation"):
        try:
            varz["saturation"] = {
                "60s": tpu.saturation(60.0),
                "300s": tpu.saturation(300.0),
            }
        except Exception as exc:   # a telemetry bug must not 500 the page
            varz["saturation"] = {"error": repr(exc)}

    engine = tpu if tpu is not None and hasattr(tpu, "stats") else None
    if engine is not None and not hasattr(engine, "saturation"):
        varz["engine"] = engine.stats()

    # HBM + device-time attribution summary: the headline
    # numbers from /debug/hbmz, inlined so one varz scrape carries them
    if tpu is not None and hasattr(tpu, "hbm_attribution"):
        try:
            report = tpu.hbm_attribution()
            varz["hbm"] = {
                "attributed_bytes": report.get("attributed_bytes"),
                "device_bytes_in_use": report.get("device_bytes_in_use"),
                "unattributed_bytes": report.get("unattributed_bytes"),
            }
            if report.get("device_seconds"):
                varz["device_seconds"] = report["device_seconds"]
        except Exception as exc:
            varz["hbm"] = {"error": repr(exc)}

    return varz


def enable_varz(app, prefix: str = "/debug/varz") -> None:
    def varz(ctx):
        return build_varz(app)

    app.get(prefix, varz)
