"""Live serving-state snapshot over HTTP: ``/debug/statusz`` (the port's
copy of ``gofr_tpu/statusz.py``, over the port's views).

The flight recorder's admin surface. Where ``/metrics`` exposes
aggregates and ``/debug/profiler`` captures device traces, ``statusz``
answers the on-call question "what is the server doing *right now*": the
batcher's pending queue depths, the generation engine's admission queue and
per-slot states, KV-cache occupancy, per-device health gauges, and the
last-N request timelines (queue wait, TTFT, tokens/s, batch sizes ridden).

Registered like the profiler — ``app.enable_statusz()`` — never on by
default. Everything rendered is host-side bookkeeping: no device syncs, so
hitting the endpoint cannot perturb serving latency.
"""

from __future__ import annotations

from typing import Any, Dict


def build_status(app, recent: int = 32) -> Dict[str, Any]:
    """Assemble the statusz snapshot from whatever serving pieces the app
    actually wired: Executor and GenerationEngine both duck-type via
    ``health_check``/``statusz``; absent pieces are simply omitted."""
    container = app.container
    status: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
    }
    # debug-surface index: every enabled /debug/* page with a
    # one-line description lives behind this link
    if getattr(app, "_debug_surfaces", None):
        status["app"]["debug_index"] = "/debug/"

    # SLO & watchdog view: windowed goodput and the degradation
    # state machine next to the queues they explain
    slo = getattr(container, "slo", None)
    if slo is not None:
        status["slo"] = slo.snapshot()
    watchdog = getattr(container, "watchdog", None)
    if watchdog is not None:
        status["watchdog"] = watchdog.statusz()

    # error-budget burn plane: per-(model, class) burn rates
    # and budget remaining — the full view (plus worst offenders) lives
    # on /debug/sloz
    plane = getattr(container, "slo_budget", None)
    if plane is not None:
        try:
            status["slo_budget"] = plane.statusz()
        except Exception as exc:   # a budget bug must not 500 statusz
            status["slo_budget"] = {"error": repr(exc)}
    offenders = getattr(container, "offenders", None)
    if offenders is not None:
        try:
            status["worst_offenders"] = offenders.snapshot(limit=8)
        except Exception as exc:
            status["worst_offenders"] = {"error": repr(exc)}

    # online auto-tuner: live operating point + guard state
    # and the last few decisions — the full candidate ledger lives on
    # /debug/tunez
    autotune = getattr(container, "autotune", None)
    if autotune is not None:
        try:
            status["autotune"] = autotune.status()
        except Exception as exc:   # a tuner bug must not 500 statusz
            status["autotune"] = {"error": repr(exc)}

    # continuous telemetry plane: compact sparkline view of
    # the time-series store plus any active anomalies — the offending
    # signal shows up both here and in the watchdog's last_reasons; the
    # full aligned series live on /debug/timez
    telemetry = getattr(container, "telemetry", None)
    if telemetry is not None:
        try:
            status["telemetry"] = telemetry.statusz()
        except Exception as exc:   # a telemetry bug must not 500 statusz
            status["telemetry"] = {"error": repr(exc)}

    # on-demand profiler: is a capture running, and where did
    # the last one land — surfaced here so trace artifacts are findable
    # without grepping logs
    profiler_state = getattr(app, "_profiler_state", None)
    if profiler_state is not None:
        from gofr_tpu_torch.profiler import profiler_status
        status["profiler"] = profiler_status(profiler_state)

    # disaggregated cluster membership (the full fleet rollup lives on
    # /debug/clusterz; this is the local replica's registry view)
    cluster = getattr(container, "cluster", None)
    if cluster is not None:
        status["cluster"] = cluster.stats()
        router = getattr(container, "cluster_router", None)
        if router is not None:
            status["cluster"]["router"] = {
                "requests": router._requests,
                "bytes_shipped": router._bytes_shipped,
                "kv_transfer_quantiles": router.transfer_quantiles(),
            }

    batcher = getattr(container, "tpu_batcher", None)
    if batcher is not None:
        status["batcher"] = {
            "max_batch": batcher.max_batch,
            "max_delay_ms": batcher.max_delay * 1000.0,
            "queue_depths": batcher.queue_depths(),
        }

    tpu = container.tpu
    if tpu is not None:
        statusz_fn = getattr(tpu, "statusz", None)
        if statusz_fn is not None:      # GenerationEngine
            status["engine"] = statusz_fn(recent=recent)
        health_fn = getattr(tpu, "health_check", None)
        if health_fn is not None:       # device liveness + HBM gauges
            status["devices"] = health_fn()
        recorder = getattr(tpu, "recorder", None)
        if recorder is not None and "engine" not in status:
            status["requests"] = recorder.snapshot(limit=recent)
        saturation_fn = getattr(tpu, "saturation", None)
        if saturation_fn is not None:   # Executor duty-cycle/MFU/HBM view
            try:
                status["saturation"] = saturation_fn()
            except Exception as exc:
                status["saturation"] = {"error": repr(exc)}
        # zero-copy data plane: staging-slab occupancy, H2D
        # totals per path, and transfer-coalescer amortization — the
        # live twin of app_tpu_h2d_bytes_total/_seconds
        data_plane_fn = getattr(tpu, "data_plane", None)
        if data_plane_fn is not None:
            try:
                status["data_plane"] = data_plane_fn()
            except Exception as exc:
                status["data_plane"] = {"error": repr(exc)}
        # per-executable roofline attribution: ranked
        # top-offenders by device-seconds — which compiled executable
        # family is burning the device, and how far from roofline; the
        # full table lives on /debug/xlaz and /debug/workloadz
        exec_ledger = getattr(tpu, "exec_ledger", None)
        if exec_ledger is not None:
            try:
                status["executables"] = exec_ledger.snapshot(limit=8)
            except Exception as exc:
                status["executables"] = {"error": repr(exc)}
        # compile-plane summary: totals + the serve-time-compile
        # window the watchdog acts on; the full table lives on /debug/xlaz
        ledger = getattr(tpu, "ledger", None)
        if ledger is not None:
            compiles = ledger.snapshot(limit=8)
            status["compiles"] = {
                "total": compiles["total"],
                "by_cause": compiles["by_cause"],
                "serving_compiles_60s": compiles["serving_compiles_60s"],
                "recent": compiles["recent"],
            }

    return status


def enable_statusz(app, prefix: str = "/debug/statusz") -> None:
    def statusz(ctx):
        try:
            recent = int(ctx.param("recent") or 32)
        except (TypeError, ValueError):
            recent = 32
        return build_status(app, recent=max(1, min(recent, 256)))

    app.get(prefix, statusz)
