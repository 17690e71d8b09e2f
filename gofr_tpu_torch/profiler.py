"""On-demand device trace capture over HTTP (the port's copy of
``gofr_tpu/profiler.py``, over ``torch.profiler``)::

  POST /debug/profiler/start {"dir": "/tmp/trace", "duration_s": 10}
  POST /debug/profiler/stop                          → stops, returns dir

Routes are registered only by ``app.enable_profiler()``, never by
default. The capture is a ``torch.profiler.profile``: on an App built
for the card its activities are the CPU and CUDA (every kernel the
process launches, CUDA-graph replays included, whichever thread launched
it); on an App built for the CPU, the CPU only. At stop it writes a
Chrome trace, ``<dir>/trace.json`` (Perfetto and ``chrome://tracing``
read it; JAX's capture is an XProf directory). A start on an App built
for the card raises where CUDA is unavailable: it never traces the CPU
in the card's place.

- **Duration cap.** Every capture stops by itself: ``duration_s``
  defaults to ``DEFAULT_DURATION_S`` and is clamped to
  ``MAX_DURATION_S``, so a forgotten ``stop`` cannot trace for ever.
- **Single flight.** One capture at a time per App; a concurrent start
  answers ``"already profiling"`` with the running capture's dir and
  remaining budget.
- **Per App.** The state lives in ``app._profiler_state`` (rendered for
  statusz by :func:`profiler_status`), so two Apps in one process do not
  see each other's session. ``torch.profiler`` itself is process-wide.

The profile is started and stopped on one thread of its own (the
profiler's state belongs to the thread that starts it), so the start
route's handler thread, the stop route's and the auto-stop timer may all
differ.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from gofr_tpu_torch.device import resolve_device

DEFAULT_DURATION_S = 15.0
MAX_DURATION_S = 120.0
TRACE_FILE = "trace.json"


def profiler_status(state: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Render one App's profiler state for statusz. Safe on None (the
    app never called ``enable_profiler``)."""
    if not state:
        return {"enabled": False}
    out: Dict[str, Any] = {
        "enabled": True,
        "running": state["dir"] is not None,
        "captures": state["captures"],
        "last_artifact_dir": state["last_dir"],
    }
    if state["dir"] is not None:
        out["dir"] = state["dir"]
        out["started_at"] = state["started_at"]
        if state["deadline"] is not None:
            out["remaining_s"] = round(
                max(0.0, state["deadline"] - time.monotonic()), 3)
    return out


def activities_for(device) -> List[Any]:
    """The profile's activities for an App's device: CPU and CUDA on the
    card (raises without CUDA), the CPU alone on the CPU."""
    from torch.profiler import ProfilerActivity

    dev = resolve_device(device)
    if dev.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


class Capture:
    """One ``torch.profiler.profile`` held by a thread of its own, from
    :meth:`start` until :meth:`stop` writes ``<trace_dir>/trace.json``."""

    def __init__(self, trace_dir: str, activities: List[Any]):
        self.trace_dir = trace_dir
        self.path = os.path.join(trace_dir, TRACE_FILE)
        self._activities = activities
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="profiler-capture")

    def start(self) -> None:
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            raise self._error

    def stop(self) -> str:
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self.path

    def _run(self) -> None:
        try:
            prof = torch.profiler.profile(activities=self._activities)
            prof.start()
        except BaseException as exc:
            self._error = exc
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(self.path)
        except BaseException as exc:
            self._error = exc


def enable_profiler(app, prefix: str = "/debug/profiler") -> None:
    state: Dict[str, Any] = {
        "dir": None,          # capture in progress → its artifact dir
        "started_at": None,   # wall clock, for the statusz surface
        "deadline": None,     # monotonic auto-stop point
        "timer": None,        # the auto-stop timer, cancelled on stop
        "capture": None,      # the running Capture
        "captures": 0,
        "last_dir": None,     # most recent finished capture's artifacts
    }
    lock = threading.Lock()
    app._profiler_state = state
    device = app.container.device

    def _stop_locked() -> Optional[str]:
        """Stop the running capture. Caller holds ``lock``."""
        if state["dir"] is None:
            return None
        timer = state["timer"]
        if timer is not None:
            timer.cancel()
        trace_dir = state["dir"]
        capture = state["capture"]
        state["dir"] = None
        state["started_at"] = None
        state["deadline"] = None
        state["timer"] = None
        state["capture"] = None
        state["captures"] += 1
        state["last_dir"] = trace_dir
        capture.stop()
        return trace_dir

    def _auto_stop(trace_dir: str) -> None:
        # runs on the timer thread: the same lock as start and stop, so a
        # racing manual stop and the deadline cannot both stop
        with lock:
            if state["dir"] != trace_dir:
                return   # already stopped manually
            _stop_locked()

    def start(ctx):
        body = ctx.bind() or {}
        trace_dir = body.get("dir") or os.path.join(tempfile.gettempdir(),
                                                    "gofr_tpu_trace")
        try:
            duration_s = float(body.get("duration_s") or DEFAULT_DURATION_S)
        except (TypeError, ValueError):
            duration_s = DEFAULT_DURATION_S
        duration_s = max(0.1, min(duration_s, MAX_DURATION_S))
        with lock:
            if state["dir"] is not None:
                return {"status": "already profiling",
                        "dir": state["dir"],
                        "remaining_s": round(
                            max(0.0, (state["deadline"] or 0.0)
                                - time.monotonic()), 3)}
            capture = Capture(trace_dir, activities_for(device))
            capture.start()
            state["capture"] = capture
            state["dir"] = trace_dir
            state["started_at"] = time.time()
            state["deadline"] = time.monotonic() + duration_s
            timer = threading.Timer(duration_s, _auto_stop, (trace_dir,))
            timer.daemon = True
            state["timer"] = timer
            timer.start()
        ctx.logger.info("profiler started -> %s (auto-stop in %.1fs)",
                        trace_dir, duration_s)
        return {"status": "started", "dir": trace_dir,
                "duration_s": duration_s}

    def stop(ctx):
        with lock:
            trace_dir = _stop_locked()
        if trace_dir is None:
            return {"status": "not profiling",
                    "last_artifact_dir": state["last_dir"]}
        ctx.logger.info("profiler stopped, trace in %s", trace_dir)
        return {"status": "stopped", "dir": trace_dir}

    app.post(f"{prefix}/start", start)
    app.post(f"{prefix}/stop", stop)
