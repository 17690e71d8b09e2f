"""Auto-tuner decision plane over HTTP: ``/debug/tunez`` (the port's copy
of ``gofr_tpu/tunez.py``).

The debug surface for the online operating-point controller
(``tpu/autotune.py``): the live operating point with provenance (which
knobs, which generation, ``source=seed|autotune|rollback``), the
bounded candidate ledger (proposed → replay score → applied / rejected
/ rolled-back, each with its reason), and the guard states (hysteresis
streaks, cooldown, compile guard, probation). This is the page an
operator reads to answer "why did — or didn't — the tuner move?"
without correlating logs.

Registered like its siblings (``varz``/``statusz``/``xlaz``) —
``app.enable_tunez()`` — never on by default. Everything rendered is
host-side bookkeeping: the ledger is a bounded ring and the operating
point a dict snapshot; rendering never syncs the device stream.
"""

from __future__ import annotations

from typing import Any, Dict


def build_tunez(app, recent: int = 64) -> Dict[str, Any]:
    container = app.container
    tunez: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
    }

    tuner = getattr(container, "autotune", None)
    if tuner is None:
        # the page stays useful on a replica without the controller:
        # show the engine's live operating point (provenance included)
        # so "what would the tuner be moving?" still has an answer
        tunez["enabled"] = False
        tpu = container.tpu
        point_fn = getattr(tpu, "operating_point", None) \
            if tpu is not None else None
        if point_fn is not None:
            try:
                tunez["operating_point"] = point_fn()
            except Exception as exc:  # telemetry must not 500 the page
                tunez["error"] = repr(exc)
        return tunez

    tunez["enabled"] = True
    try:
        tunez.update(tuner.status())
        tunez["ledger"] = tuner.ledger()[-recent:]
    except Exception as exc:
        tunez["error"] = repr(exc)
    return tunez


def enable_tunez(app, prefix: str = "/debug/tunez") -> None:
    def tunez(ctx):
        try:
            recent = int(ctx.param("recent") or 64)
        except (TypeError, ValueError):
            recent = 64
        return build_tunez(app, recent=max(1, min(recent, 64)))

    app.get(prefix, tunez)
