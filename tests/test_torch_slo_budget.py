"""Port parity for the error-budget plane (``slo_budget.py``) against the
JAX package on the CPU.

Each case of the JAX package's own tests (``tests/test_slo_budget.py``:
sustained violations, the fast pair needing both windows, a counter
reset, a tier hop, an objective override, the watchdog's reasons and the
brownout gate) runs twice over the same scripted
``app_tpu_slo_total{model,cls,outcome}`` counters and clock: once
through JAX's store, tracker, metrics and plane, once through the
port's. ``evaluate()``, ``statusz()``, ``watchdog_reasons()``,
``fast_burning()``, the burn-rate and budget gauges, and the watchdog's
and ladder's decisions must be equal, and each case's own assertion
holds on the port.
"""

import time
from types import SimpleNamespace

import pytest

from gofr_tpu import slo as jax_slo
from gofr_tpu import slo_budget as jax_budget
from gofr_tpu.container import new_mock_container
from gofr_tpu.metrics import timeseries as jax_ts
from gofr_tpu_torch import slo as pt_slo
from gofr_tpu_torch import slo_budget as pt_budget
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.metrics import timeseries as pt_ts

KITS = {
    "jax": SimpleNamespace(ts=jax_ts, slo=jax_slo, budget=jax_budget,
                           metrics=lambda: new_mock_container().metrics),
    "port": SimpleNamespace(ts=pt_ts, slo=pt_slo, budget=pt_budget,
                            metrics=lambda: register_engine_metrics(
                                Manager())),
}
GAUGES = ("app_tpu_slo_burn_rate", "app_tpu_slo_budget_remaining")


def _plane(kit, **kwargs):
    metrics = kit.metrics()
    store = kit.ts.TimeSeriesStore(detector_min_baseline=100_000)
    slo = kit.slo.SLOTracker(metrics=metrics)
    plane = kit.budget.ErrorBudgetPlane(store, metrics, **kwargs)
    return metrics, store, slo, plane


def _seed(slo, plane, store, t0, cls="interactive", model="llama"):
    slo.record_outcome("ok", cls=cls, model=model)
    plane.evaluate(now=t0)
    store.sample(now=t0)


def _gauges(metrics):
    snap = metrics.snapshot()
    return {name: dict(snap[name].series) for name in GAUGES}


def _sustained(kit):
    metrics, store, slo, plane = _plane(kit)
    t0 = 5_000.0
    _seed(slo, plane, store, t0)
    for i in range(1, 31):
        slo.record_outcome("violated", cls="interactive", model="llama")
        store.sample(now=t0 + i)
    state = plane.evaluate(now=t0 + 30)
    (entry,) = state["budgets"]
    assert any(b["window"] == "fast" for b in entry["burning"])
    assert "window=fast" in " ".join(state["reasons"])
    return [state, plane.statusz(now=t0 + 30), plane.fast_burning(),
            _gauges(metrics)]


def _both_windows(kit):
    metrics, store, slo, plane = _plane(kit)
    t0 = 80_000.0
    _seed(slo, plane, store, t0)
    t = t0
    for _ in range(360):
        t += 10.0
        slo.record_outcome("ok", cls="interactive", model="llama")
        store.sample(now=t)
    for _ in range(3):
        t += 10.0
        for _ in range(10):
            slo.record_outcome("violated", cls="interactive", model="llama")
        store.sample(now=t)
    out = [plane.evaluate(now=t), plane.fast_burning()]
    assert out[1] is False
    for _ in range(30):
        t += 10.0
        for _ in range(10):
            slo.record_outcome("violated", cls="interactive", model="llama")
        store.sample(now=t)
    out += [plane.evaluate(now=t), plane.fast_burning(), _gauges(metrics)]
    assert out[3] is True
    return out


def _counter_reset(kit):
    _, store, slo, plane = _plane(kit)
    t0 = 9_000.0
    _seed(slo, plane, store, t0)
    for i in range(1, 21):
        slo.record_outcome("violated", cls="interactive", model="llama")
        store.sample(now=t0 + i)
    out = [plane.evaluate(now=t0 + 20)]
    plane.metrics = kit.metrics()
    restarted = kit.slo.SLOTracker(metrics=plane.metrics)
    restarted.record_outcome("ok", cls="interactive", model="llama")
    store.sample(now=t0 + 21)
    for i in range(22, 42):
        restarted.record_outcome("ok", cls="interactive", model="llama")
        store.sample(now=t0 + i)
    state = plane.evaluate(now=t0 + 41)
    (entry,) = state["budgets"]
    assert all(b is None or b >= 0.0 for b in entry["burn"].values())
    assert entry["bad_fraction"]["5m"] < 1.0
    return out + [state, _gauges(plane.metrics)]


def _tier_hop(kit):
    metrics, store, slo, plane = _plane(kit)
    t0 = 50_000.0
    _seed(slo, plane, store, t0)
    t = t0
    for _ in range(380):
        t += 10.0
        slo.record_outcome("violated", cls="interactive", model="llama")
        for _ in range(9):
            slo.record_outcome("ok", cls="interactive", model="llama")
        store.sample(now=t)
    state = plane.evaluate(now=t)
    entry = state["budgets"][0]
    assert entry["burn"]["5m"] == pytest.approx(entry["burn"]["4h"],
                                                rel=0.05)
    assert sorted(b["window"] for b in entry["burning"]) == ["slow"]
    return [state, plane.statusz(now=t), _gauges(metrics)]


def _override(kit):
    metrics, store, slo, plane = _plane(
        kit, objective_pct=99.0,
        objective_override=lambda cls: 90.0 if cls == "batch" else None)
    t0 = 30_000.0
    slo.record_outcome("ok", cls="interactive", model="m")
    slo.record_outcome("ok", cls="batch", model="m")
    plane.evaluate(now=t0)
    store.sample(now=t0)
    for i in range(1, 21):
        slo.record_outcome("violated", cls="interactive", model="m")
        slo.record_outcome("violated", cls="batch", model="m")
        store.sample(now=t0 + i)
    state = plane.evaluate(now=t0 + 20)
    by_cls = {entry["cls"]: entry for entry in state["budgets"]}
    assert by_cls["interactive"]["burn"]["5m"] == pytest.approx(
        10.0 * by_cls["batch"]["burn"]["5m"], rel=0.01)
    return [state, plane.statusz(now=t0 + 20), _gauges(metrics)]


def _watchdog(kit):
    _, store, slo, plane = _plane(kit)
    # budget_fn evaluates on the real clock: samples in its recent past
    base = time.monotonic() - 40.0
    _seed(slo, plane, store, base)
    for i in range(1, 31):
        slo.record_outcome("violated", cls="interactive", model="llama")
        store.sample(now=base + i)
    ladder = kit.slo.BrownoutLadder(escalate_after=1)
    ladder.escalation_gate = plane.fast_burning
    dog = kit.slo.Watchdog(slo, min_attainment=0.0, hysteresis=1,
                           brownout=ladder, budget_fn=plane.watchdog_reasons)
    state = dog.evaluate()
    assert state == kit.slo.STATE_DEGRADED and ladder.level == 1
    return [state, list(dog._last_reasons), ladder.level,
            plane.watchdog_reasons()]


def _gate(kit):
    _, store, slo, plane = _plane(kit)
    t0 = 7_000.0
    _seed(slo, plane, store, t0)
    ladder = kit.slo.BrownoutLadder(escalate_after=2, recover_after=2)
    ladder.escalation_gate = plane.fast_burning
    levels = []
    # pressure with no burn: the rung holds
    for i in range(1, 4):
        slo.record_outcome("ok", cls="interactive", model="llama")
        store.sample(now=t0 + i)
        plane.evaluate(now=t0 + i)
        levels.append(ladder.observe(True))
    # a fast burn opens the gate
    for i in range(4, 40):
        slo.record_outcome("violated", cls="interactive", model="llama")
        store.sample(now=t0 + i)
    plane.evaluate(now=t0 + 39)
    levels.append(ladder.observe(True))
    levels += [ladder.observe(False), ladder.observe(False)]
    assert levels[:3] == [0, 0, 0] and levels[3] == 1 and levels[-1] == 0
    return [levels, ladder._gate_held, plane.fast_burning()]


CASES = {"sustained": _sustained, "both_windows": _both_windows,
         "counter_reset": _counter_reset, "tier_hop": _tier_hop,
         "override": _override, "watchdog": _watchdog, "gate": _gate}


@pytest.mark.parametrize("case", list(CASES))
def test_budget_plane_as_jax(case):
    jax_out = CASES[case](KITS["jax"])
    port_out = CASES[case](KITS["port"])
    assert port_out == jax_out


def test_windows_pairs_and_factory_as_jax():
    assert (pt_budget.WINDOWS, pt_budget.PAIRS, pt_budget.ACCOUNTING_WINDOW,
            pt_budget.SOURCE_METRIC, pt_budget.ErrorBudgetPlane.MAX_PAIRS) \
        == (jax_budget.WINDOWS, jax_budget.PAIRS,
            jax_budget.ACCOUNTING_WINDOW, jax_budget.SOURCE_METRIC,
            jax_budget.ErrorBudgetPlane.MAX_PAIRS)

    class Config:
        def __init__(self, values):
            self.values = values

        def get_bool(self, key, default):
            return self.values.get(key, default)

        def get_float(self, key, default):
            return float(self.values.get(key, default))

    store, metrics = pt_ts.TimeSeriesStore(), register_engine_metrics(
        Manager())
    config = Config({"SLO_OBJECTIVE_PCT": 99.5,
                     "SLO_OBJECTIVE_PCT_BATCH": 95.0})
    plane = pt_budget.new_error_budget(config, store, metrics)
    jax_plane = jax_budget.new_error_budget(
        config, jax_ts.TimeSeriesStore(), new_mock_container().metrics)
    assert plane.objective_pct == jax_plane.objective_pct == 99.5
    assert plane._objective("batch") == jax_plane._objective("batch") == 95.0
    assert pt_budget.new_error_budget(config, None, metrics) is None
    assert pt_budget.new_error_budget(
        Config({"SLO_BUDGET_ENABLED": False}), store, metrics) is None
