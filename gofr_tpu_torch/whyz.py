"""Automated slow-request diagnosis over HTTP: ``/debug/whyz`` (the
port's copy of ``gofr_tpu/whyz.py``).

``/debug/whyz/{trace_id}`` answers *why was this request slow* without
the operator hand-joining statusz, timez, and xlaz: it finds the
request's flight record and runs the deterministic rule table in
:mod:`gofr_tpu_torch.tpu.diagnose` against the time-window context.

Two sources, preferred in order:

- the worst-offender ring, when the request landed in it — the verdict
  there was computed *at finish time*, against the window context the
  request actually ran under;
- the live flight recorder otherwise — the verdict is computed on
  demand against the *current* window context (marked
  ``source="live"``: for a request finished long ago the context may
  have moved on).

Bare ``/debug/whyz`` lists the worst-offender ring, so a burning sloz
page links here without a trace id in hand. Registered like the other
debug surfaces — ``app.enable_whyz()`` — never on by default.
"""

from __future__ import annotations

from typing import Any, Dict

from gofr_tpu_torch.tpu.diagnose import build_window_context, diagnose


def _current_context(container) -> Dict[str, Any]:
    tpu = getattr(container, "tpu", None)
    engine = tpu if tpu is not None and hasattr(tpu, "stats") else None
    return build_window_context(
        engine=engine,
        store=getattr(container, "telemetry", None),
        ledger=getattr(tpu, "ledger", None) if tpu is not None else None,
        xledger=(getattr(tpu, "exec_ledger", None)
                 if tpu is not None else None))


def build_whyz(app, trace_id: str) -> Dict[str, Any]:
    """One trace id → ranked verdicts. App-independent assembly so
    tests and smoke scripts call it without HTTP."""
    container = app.container
    offenders = getattr(container, "offenders", None)
    if offenders is not None:
        entry = offenders.find(trace_id)
        if entry is not None:
            return {
                "trace_id": trace_id,
                "source": "offender_ring",
                "e2e_s": entry["e2e_s"],
                "record": entry["record"],
                "verdicts": entry["verdicts"],
            }
    from gofr_tpu_torch.clusterz import _local_records
    records = _local_records(container, trace_id)
    if not records:
        return {"trace_id": trace_id, "source": None,
                "error": "no flight record for this trace id",
                "verdicts": []}
    record = records[-1]   # newest record for the trace
    ctx = _current_context(container)
    return {
        "trace_id": trace_id,
        "source": "live",
        "record": record,
        "context": ctx,
        "verdicts": diagnose(record, ctx),
    }


def build_whyz_index(app) -> Dict[str, Any]:
    container = app.container
    offenders = getattr(container, "offenders", None)
    return {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
        "usage": "GET /debug/whyz/{trace_id} for a ranked verdict list",
        "worst_offenders": (offenders.snapshot()
                            if offenders is not None else None),
    }


def enable_whyz(app, prefix: str = "/debug/whyz") -> None:
    def whyz_index(ctx):
        return build_whyz_index(app)

    def whyz(ctx):
        return build_whyz(app, ctx.path_param("trace_id"))

    app.get(prefix, whyz_index)
    app.get(f"{prefix}/{{trace_id}}", whyz)
