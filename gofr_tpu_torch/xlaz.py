"""Compile-plane & shape snapshot over HTTP: ``/debug/xlaz`` (the port's
copy of ``gofr_tpu/xlaz.py``; the page keeps JAX's name).

Where statusz shows what the server is doing and varz how well, xlaz
shows what the compile plane underneath is doing. In the port a compile
is a CUDA-graph capture: every capture the process ran (warmup vs
serve-time, durations, fingerprints), how the observed batch-size
distribution fits the registered bucket ladder, how many device rows are
padding, and a padding-optimal suggested ladder derived from real
traffic: deploy with a guess, read ``suggested_ladder`` after a day of
traffic, redeploy with it.

Registered like its siblings — ``app.enable_xlaz()`` — never on by
default. Everything rendered is host-side bookkeeping: the ledger and
shape stats are O(1) appends on the serving path, and rendering them
never syncs the device stream.
"""

from __future__ import annotations

from typing import Any, Dict


def build_xlaz(app, recent: int = 64) -> Dict[str, Any]:
    container = app.container
    xlaz: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
    }

    tpu = container.tpu
    if tpu is not None:
        # Executor and GenerationEngine both duck-type xlaz(); anything
        # else with just a ledger still gets its compile table rendered
        xlaz_fn = getattr(tpu, "xlaz", None)
        if xlaz_fn is not None:
            try:
                xlaz.update(xlaz_fn(recent=recent))
            except Exception as exc:  # a telemetry bug must not 500 the page
                xlaz["error"] = repr(exc)
        else:
            ledger = getattr(tpu, "ledger", None)
            if ledger is not None:
                xlaz["compiles"] = ledger.snapshot(limit=recent)

    batcher = getattr(container, "tpu_batcher", None)
    if batcher is not None:
        xlaz["batcher"] = {
            "max_batch": batcher.max_batch,
            "max_delay_ms": batcher.max_delay * 1000.0,
            "flush_causes": dict(batcher.flush_causes),
        }

    return xlaz


def enable_xlaz(app, prefix: str = "/debug/xlaz") -> None:
    def xlaz(ctx):
        try:
            recent = int(ctx.param("recent") or 64)
        except (TypeError, ValueError):
            recent = 64
        return build_xlaz(app, recent=max(1, min(recent, 256)))

    app.get(prefix, xlaz)
