"""Workload-shape snapshot over HTTP: ``/debug/workloadz`` (the port's
copy of ``gofr_tpu/workloadz.py``).

Where statusz shows what the server is doing *now* and xlaz what the
compile plane captured, workloadz shows what the *traffic* looks like: the
bounded shape-only ring the :class:`~gofr_tpu_torch.tpu.workload.
TrafficRecorder` keeps — inter-arrival and token-length histograms,
SLO-class and finish-reason mixes, the prefix-reuse rate, and the
batcher plane's enqueue pulse — plus the per-executable device-time
roofline table from whichever engine/executor is mounted. With
``?trace=1`` the page returns the versioned compact trace export
instead, the artifact ``tpu.workload.load_trace`` replays.

Registered like its siblings — ``app.enable_workloadz()`` — never on by
default, and rendering never syncs the device stream. Shape only: the
recorder stores token *counts*, never token ids or strings.
"""

from __future__ import annotations

from typing import Any, Dict


def build_workloadz(app, recent: int = 64,
                    trace: bool = False) -> Dict[str, Any]:
    container = app.container
    recorder = getattr(container, "workload", None)
    if trace and recorder is not None:
        return recorder.export_trace()
    workloadz: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
        "enabled": recorder is not None,
    }
    if recorder is not None:
        try:
            workloadz["workload"] = recorder.snapshot()
        except Exception as exc:  # a telemetry bug must not 500 the page
            workloadz["error"] = repr(exc)

    tpu = container.tpu
    if tpu is not None:
        # engine and executor both carry an ExecutableLedger;
        # anything else mounted simply has no roofline table to render
        ledger = getattr(tpu, "exec_ledger", None)
        if ledger is not None:
            try:
                workloadz["executables"] = ledger.snapshot(limit=recent)
            except Exception as exc:
                workloadz["executables_error"] = repr(exc)

    return workloadz


def enable_workloadz(app, prefix: str = "/debug/workloadz") -> None:
    def workloadz(ctx):
        try:
            recent = int(ctx.param("recent") or 64)
        except (TypeError, ValueError):
            recent = 64
        trace = str(ctx.param("trace") or "").strip() in ("1", "true")
        return build_workloadz(app, recent=max(1, min(recent, 256)),
                               trace=trace)

    app.get(prefix, workloadz)
