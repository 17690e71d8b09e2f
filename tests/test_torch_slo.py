"""Port parity for the SLO control loop and the telemetry plane's host
modules against the JAX package (CPU, no engine).

- ``SLOTracker``, ``Watchdog`` and ``BrownoutLadder``, fed one seeded
  sequence of events (TTFTs, tokens, outcomes by class, serving
  compiles, HBM occupancy, anomaly and budget reasons), each clock
  driven through ``now=``: after every evaluation the same state,
  reasons, ladder level and applied levels, and at the end the same
  snapshots and the same metric series (gauges included) as JAX's.
- ``new_watchdog`` and ``new_brownout`` over one config object build
  the same controllers as JAX's.
- The ladder stamps its level changes on the active span (the port's
  contextvar, not the JAX package's).
- Where the port differs on purpose: a failing seam raises out of the
  evaluation, and a timer evaluation that raises ends the timer and is
  raised again by ``stop()``.
- The copies: ``WindowedDigest``/``WindowedCounter``, ``Manager``,
  ``traceparent`` parsing, ``FlightRecorder``, ``ExecutableLedger`` /
  ``charge_device_time`` / ``ShapeStats`` / ``suggest_ladder`` give
  JAX's values on seeded inputs.
"""

import asyncio

import numpy as np
import pytest

from gofr_tpu import slo as jax_slo
from gofr_tpu.container import new_mock_container
from gofr_tpu.metrics import digest as jax_digest
from gofr_tpu.metrics import manager as jax_manager
from gofr_tpu.tpu import compile_ledger as jax_ledger
from gofr_tpu.tpu import flightrecorder as jax_fr
from gofr_tpu.trace import tracer as jax_tracer
from gofr_tpu_torch import slo as pt_slo
from gofr_tpu_torch.metrics import digest as pt_digest
from gofr_tpu_torch.metrics import manager as pt_manager
from gofr_tpu_torch.metrics import register_engine_metrics
from gofr_tpu_torch.tpu import compile_ledger as pt_ledger
from gofr_tpu_torch.tpu import flightrecorder as pt_fr
from gofr_tpu_torch.trace import tracer as pt_tracer

CLASSES = ("interactive", "standard", "batch")
OUTCOMES = ("ok", "ok", "ok", "violated", "expired", "error")


def _series(manager):
    """Every series of the SLO plane's and the test's own names (the
    mock container's other parts write theirs on their own clock)."""
    out = {}
    for name, metric in manager.snapshot().items():
        if not name.startswith(("app_tpu_", "app_health_")):
            continue
        for key, value in metric.series.items():
            out[name, key] = (dict(value, exemplars=None)
                              if isinstance(value, dict) else value)
    return out


def _script(seed, n=400):
    """A seeded event sequence over ~10 minutes of clock: each entry
    (now, kind, args). Pressure comes in waves, so the watchdog and the
    ladder climb and recover."""
    rng = np.random.default_rng(seed)
    now, events = 100.0, []
    for i in range(n):
        now += float(rng.uniform(0.2, 3.0))
        bad = (i // 80) % 3 == 1          # one block in three is bad
        kind = rng.choice(["ttft", "tokens", "outcome", "evaluate"],
                          p=[0.3, 0.25, 0.3, 0.15])
        if kind == "ttft":
            scale = 1.5 if bad else 0.05
            events.append((now, "ttft", float(rng.exponential(scale))))
        elif kind == "tokens":
            events.append((now, "tokens", float(rng.integers(1, 64))))
        elif kind == "outcome":
            # bad blocks: 70% bad outcomes; calm ones: 2%
            outcome = (OUTCOMES[int(rng.integers(3, 6))]
                       if rng.random() < (0.7 if bad else 0.02) else "ok")
            events.append((now, "outcome", (
                outcome, float(rng.integers(0, 200)),
                CLASSES[int(rng.integers(0, 3))], f"t{i}",
                float(rng.uniform(0, 2)) if outcome == "violated"
                else None)))
        else:
            events.append((now, "evaluate", (
                int(rng.integers(0, 6)) if bad else 0,        # compiles
                float(rng.uniform(0.5, 1.0)),                 # occupancy
                ["anomaly: goodput"] if bad and rng.random() < 0.3 else [],
                ["budget: interactive 5m"] if bad and rng.random() < 0.2
                else [])))
    return events


class _Ledger:
    """A ``serving_compiles(window_s, now)`` source over noted instants."""

    def __init__(self):
        self.at = []

    def serving_compiles(self, window_s=60.0, now=None):
        return sum(1 for t in self.at if now - t <= window_s)


def _loop(mod, metrics, events, watchdog_kw, ladder_kw):
    slo = mod.SLOTracker(metrics)
    ledger, feed, applied = _Ledger(), {}, []
    ladder = mod.BrownoutLadder(applied.append, metrics=metrics,
                                **ladder_kw)
    dog = mod.Watchdog(slo, metrics=metrics, ledger=ledger,
                       hbm_fn=lambda: feed["hbm"], brownout=ladder,
                       anomaly_fn=lambda: feed["anomaly"],
                       budget_fn=lambda: feed["budget"], **watchdog_kw)
    trail = []
    for now, kind, args in events:
        if kind == "ttft":
            slo.record_ttft(args, now=now)
        elif kind == "tokens":
            slo.record_tokens(args, now=now)
        elif kind == "outcome":
            outcome, tokens, cls, trace_id, late = args
            slo.record_outcome(outcome, tokens=tokens, now=now, cls=cls,
                               model="m", trace_id=trace_id,
                               late_by_s=late)
        else:
            compiles, feed["hbm"], feed["anomaly"], feed["budget"] = args
            ledger.at += [now] * compiles
            state = dog.evaluate(now=now)
            trail.append((state, list(dog._last_reasons), ladder.level,
                          dog.statusz()))
    end = events[-1][0]
    slo.export_gauges(now=end)
    return dict(trail=trail, applied=applied, snapshot=slo.snapshot(end),
                attainment=[slo.attainment(w, end) for w in (60.0, 300.0)],
                series=_series(metrics))


CONFIGS = {
    "default": (dict(min_attainment=0.9, max_p99_ttft_s=1.0,
                     max_serving_compiles=3, max_hbm_occupancy=0.95,
                     hysteresis=2), dict()),
    "fast": (dict(min_attainment=0.8, hysteresis=1, window_s=30.0,
                  min_requests=3, max_serving_compiles=5),
             dict(escalate_after=1, recover_after=2)),
}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_loop_as_jax(seed, config):
    events = _script(seed)
    watchdog_kw, ladder_kw = CONFIGS[config]
    want = _loop(jax_slo, new_mock_container().metrics, events,
                 watchdog_kw, ladder_kw)
    got = _loop(pt_slo, register_engine_metrics(pt_manager.Manager()),
                events, watchdog_kw, ladder_kw)
    assert got["trail"] == want["trail"]
    assert got["applied"] == want["applied"]
    assert got["snapshot"] == want["snapshot"]
    assert got["attainment"] == want["attainment"]
    assert got["series"] == want["series"]
    # the sequence exercises the loop: degraded and back, ladder up and
    # down
    states = {state for state, _, _, _ in got["trail"]}
    assert states == {"READY", "DEGRADED"}
    assert max(got["applied"]) >= 1
    assert any(b < a for a, b in zip(got["applied"], got["applied"][1:]))


class _Config:
    def __init__(self, values):
        self.values = values

    def get_bool(self, key, default=False):
        value = self.values.get(key)
        return default if value is None else value.lower() == "true"

    def get_float(self, key, default=0.0):
        value = self.values.get(key)
        return default if value is None else float(value)

    def get_or_default(self, key, default):
        return self.values.get(key, default)


class _Engine:
    def __init__(self):
        self.levels = []

    def set_brownout(self, level):
        self.levels.append(level)


@pytest.mark.parametrize("values", [
    {},
    {"SLO_WATCHDOG_ENABLED": "false", "BROWNOUT_ENABLED": "false"},
    {"SLO_MAX_P99_TTFT_MS": "250", "SLO_MAX_SERVING_COMPILES": "0",
     "SLO_MAX_HBM_OCCUPANCY": "0.9", "SLO_WATCHDOG_HYSTERESIS": "2",
     "CLUSTER_ROLE": "decode", "BROWNOUT_ESCALATE_AFTER": "1",
     "BROWNOUT_RECOVER_AFTER": "3", "SLO_WINDOW_S": "30"},
])
def test_factories_as_jax(values):
    config = _Config(values)
    built = {}
    for name, mod in (("jax", jax_slo), ("port", pt_slo)):
        dog = mod.new_watchdog(config, mod.SLOTracker(), ledger=_Ledger())
        engine = _Engine()
        ladder = mod.new_brownout(config, engine)
        built[name] = (dog.statusz() if dog else None,
                       ladder.statusz() if ladder else None,
                       dog.interval_s if dog else None,
                       ladder.role if ladder else None)
    assert built["port"] == built["jax"]
    assert pt_slo.new_brownout(config, object()) is None


def test_ladder_stamps_levels_on_the_active_span():
    """The level events land on the port's active span; a span opened
    with the JAX package's tracer is not the port's current span."""
    exporter = pt_tracer.ListExporter()
    tracer = pt_tracer.Tracer(exporter=exporter)
    ladder = pt_slo.BrownoutLadder(escalate_after=1, recover_after=1)
    with tracer.start_span("evaluate") as span:
        ladder.observe(True)
        ladder.observe(True)
        ladder.observe(False)
    events = span.find_events("brownout.level")
    assert [(e["attributes"]["previous"], e["attributes"]["level"])
            for e in events] == [("0", "1"), ("1", "2"), ("2", "1")]
    jax_side = jax_tracer.Tracer().start_span("jax-request")
    with jax_side:
        assert pt_tracer.current_span() is None
        ladder.observe(True)
    assert ladder.level == 2 and not jax_side.find_events("brownout.level")
    tracer.shutdown()


def test_failing_seams_raise():
    """The port's controllers do not swallow a failing seam (the JAX
    package's log it and go on): the evaluation raises."""
    def broken():
        raise RuntimeError("seam down")

    for seam in ("hbm_fn", "anomaly_fn", "budget_fn"):
        kw = {seam: broken}
        if seam == "hbm_fn":
            kw["max_hbm_occupancy"] = 0.9
        jax_slo.Watchdog(jax_slo.SLOTracker(), **kw).evaluate(now=10.0)
        with pytest.raises(RuntimeError, match="seam down"):
            pt_slo.Watchdog(pt_slo.SLOTracker(), **kw).evaluate(now=10.0)
    ladder = pt_slo.BrownoutLadder(lambda level: broken(), escalate_after=1)
    with pytest.raises(RuntimeError, match="seam down"):
        ladder.observe(True)
    gated = pt_slo.BrownoutLadder(escalate_after=1)
    gated.escalation_gate = broken
    with pytest.raises(RuntimeError, match="seam down"):
        gated.observe(True)


def test_watchdog_timer_evaluates_and_stop_raises_its_failure():
    async def main():
        slo = pt_slo.SLOTracker()
        dog = pt_slo.Watchdog(slo, interval_s=0.005, hysteresis=1)
        calls = []
        evaluate = dog.evaluate

        def counted(now=None):
            calls.append(now)
            if len(calls) == 3:
                raise ValueError("accounting bug")
            return evaluate(now)
        dog.evaluate = counted
        dog.start()
        await asyncio.sleep(0.2)
        with pytest.raises(ValueError, match="accounting bug"):
            await dog.stop()
        assert len(calls) == 3
        ok = pt_slo.Watchdog(slo, interval_s=0.005)
        ok.start()
        await asyncio.sleep(0.03)
        await ok.stop()
        assert ok.state == "READY"

    asyncio.run(main())


@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_digest_and_counter_as_jax(seed):
    rng = np.random.default_rng(seed)
    values = rng.lognormal(-2.0, 1.5, 3000)
    times = np.cumsum(rng.uniform(0.0, 0.3, 3000)) + 50.0
    digests = [mod.WindowedDigest() for mod in (jax_digest, pt_digest)]
    counters = [mod.WindowedCounter() for mod in (jax_digest, pt_digest)]
    for value, now in zip(values, times):
        for d, c in zip(digests, counters):
            d.record(float(value), now=float(now))
            c.add(float(value), now=float(now))
    end = float(times[-1])
    for window in (10.0, 60.0, 300.0):
        assert digests[1].snapshot(now=end) == digests[0].snapshot(now=end)
        assert [digests[1].quantile(q, window, end) for q in (0, .5, 1)] \
            == [digests[0].quantile(q, window, end) for q in (0, .5, 1)]
        assert counters[1].sum(window, end) == counters[0].sum(window, end)
    assert counters[1].total() == counters[0].total()


class _Log:
    def __init__(self):
        self.errors = []

    def error(self, message, *args):
        self.errors.append(message % args if args else message)


def test_manager_as_jax():
    out = []
    for mod in (jax_manager, pt_manager):
        log = _Log()
        manager = mod.new_manager(log)
        manager.new_counter("app_tpu_c")
        manager.new_updown_counter("app_tpu_u")
        manager.new_gauge("app_tpu_g")
        manager.new_histogram("app_tpu_h", "", (0.1, 1.0))
        manager.increment_counter("app_tpu_c", model="m")
        manager.delta_updown_counter("app_tpu_u", 2.5, cls="batch")
        manager.set_gauge("app_tpu_g", 7.0)
        manager.record_histogram("app_tpu_h", 0.5, exemplar={"trace_id": "t"},
                                 model="m")
        manager.increment_counter("app_tpu_missing")
        manager.set_gauge("app_tpu_c", 1.0)
        manager.new_gauge("app_tpu_g")
        out.append((_series(manager), log.errors,
                    manager.value("app_tpu_h", model="m")))
    assert out[1] == out[0] and len(out[1][1]) == 3


def test_traceparent_and_spans_as_jax():
    for header in ("00-" + "a" * 32 + "-" + "b" * 16 + "-01", "",
                   "00-" + "0" * 32 + "-" + "b" * 16 + "-01", "garbage",
                   " 00-" + "A" * 32 + "-" + "c" * 16 + "-00 "):
        assert pt_tracer.extract_traceparent(header) \
            == jax_tracer.extract_traceparent(header)
    exporter = pt_tracer.ListExporter()
    tracer = pt_tracer.Tracer(exporter=exporter)
    parent = tracer.start_span("parent",
                               remote_parent={"trace_id": "a" * 32,
                                              "span_id": "b" * 16})
    with parent:
        child = tracer.start_span("child")
        child.add_event("x", k=1)
        child.finish()
    assert child.trace_id == "a" * 32 and child.parent_id == parent.span_id
    assert pt_tracer.format_traceparent(child) \
        == f"00-{'a' * 32}-{child.span_id}-01"
    tracer.shutdown()
    assert [s.name for s in exporter.spans] == ["child", "parent"]
    assert tracer.dropped == 0 and pt_tracer.current_span() is None


def test_tracer_shutdown_raises_an_export_failure():
    class Broken(pt_tracer.ListExporter):
        def export(self, spans):
            raise OSError("collector down")

    tracer = pt_tracer.Tracer(exporter=Broken())
    tracer.start_span("lost").finish()
    with pytest.raises(OSError, match="collector down"):
        tracer.shutdown()


def _records(mod):
    recorder = mod.FlightRecorder(capacity=3, step_capacity=2)
    out = []
    for i in range(5):
        record = recorder.start(mod.RequestRecord(
            model="m", prompt_len=i + 3, budget=8, trace_id=f"t{i % 2}"))
        record.admitted()
        for size in (4, 2, 3)[:i % 3 + 1]:
            record.rode_batch(size)
        record.tokens = i
        if i:
            record.first_token()
        recorder.finish(record, ("done", "error", "cancelled")[i % 3])
        recorder.record_step("m", 16, i + 1, {"device_wait": 0.001 * i})
    snap = recorder.snapshot()
    for entry in snap["recent"]:
        for key in ("enqueued_at", "queue_wait_s", "ttft_s",
                    "tokens_per_s"):
            entry.pop(key)
    for entry in snap["steps"]:
        entry.pop("at")
    out.append(snap)
    out.append([{k: v for k, v in r.items() if k not in (
        "timing", "enqueued_at", "queue_wait_s", "ttft_s", "tokens_per_s")}
        for r in recorder.find("t1")])
    return out


def test_flight_recorder_as_jax():
    assert _records(pt_fr) == _records(jax_fr)


@pytest.mark.parametrize("seed", [0, 1])
def test_compile_ledger_as_jax(seed):
    out = []
    for mod in (jax_ledger, pt_ledger):
        metrics = (register_engine_metrics(pt_manager.Manager())
                   if mod is pt_ledger else new_mock_container().metrics)
        ledger = mod.ExecutableLedger(metrics=metrics, max_families=6)
        shapes = mod.ShapeStats(metrics)
        seconds = {}
        draws = np.random.default_rng(seed)
        for i in range(120):
            n = int(draws.integers(1, 40))
            shapes.record("prompt", n, next(b for b in (8, 16, 32, 64)
                                            if b >= n), now=float(i))
            mod.charge_device_time(
                float(draws.uniform(0.001, 0.01)), "m",
                classes=list(draws.choice(["batch", "interactive"],
                                          int(draws.integers(1, 4)))),
                family=f"decode[k={int(draws.integers(1, 9))},w=64]",
                device_seconds=seconds, metrics=metrics, ledger=ledger)
        observed = shapes.distribution("prompt")
        out.append((ledger.snapshot(limit=8), shapes.snapshot(now=119.0),
                    observed, shapes.bucket_hits("prompt"), seconds,
                    [mod.suggest_ladder(observed, rungs, 4)
                     for rungs in (1, 2, 4)],
                    _series(metrics)))
    jax_out, port_out = out
    assert port_out[:6] == jax_out[:6]
    names = {name for name, _ in port_out[6]}
    assert {k: v for k, v in jax_out[6].items() if k[0] in names} \
        == port_out[6]
