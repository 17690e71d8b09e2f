"""Error-budget burn view over HTTP: ``/debug/sloz`` (the port's copy of
``gofr_tpu/sloz.py``).

The judgment twin of ``/debug/varz``: where varz reports windowed
attainment, sloz answers the paging question — *which (model, class)
budget is burning, how fast, and who are the worst offenders right
now*. The payload is the :class:`~gofr_tpu_torch.slo_budget.ErrorBudgetPlane`
evaluation (per-pair burn rates over the 5m/1h/4h windows, budget
remaining over the 4h accounting window, and the burning verdicts the
watchdog's ``budget_fn`` feeds on), the watchdog's current state so a
DEGRADED flip reads next to the burn that caused it, and the
worst-offender ring's summary — each slow request already linked to its
/debug/whyz verdict.

Registered like the other debug surfaces — ``app.enable_sloz()`` —
never on by default. Every answer is arithmetic over bounded rings;
nothing here touches the device.
"""

from __future__ import annotations

from typing import Any, Dict


def build_sloz(app) -> Dict[str, Any]:
    container = app.container
    out: Dict[str, Any] = {
        "app": {
            "name": container.app_name,
            "version": container.app_version,
        },
    }
    plane = getattr(container, "slo_budget", None)
    if plane is None:
        out["slo_budget"] = None
        return out
    out["slo_budget"] = plane.statusz()
    watchdog = getattr(container, "watchdog", None)
    if watchdog is not None:
        out["watchdog"] = {
            "state": watchdog.state,
            "last_reasons": list(watchdog._last_reasons),
        }
    offenders = getattr(container, "offenders", None)
    if offenders is not None:
        out["worst_offenders"] = offenders.snapshot()
    return out


def enable_sloz(app, prefix: str = "/debug/sloz") -> None:
    def sloz(ctx):
        return build_sloz(app)

    app.get(prefix, sloz)
