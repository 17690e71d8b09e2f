"""Port parity for the telemetry store (``metrics/timeseries.py``) and
``hbmz.hbm_occupancy`` against the JAX package on the CPU.

- ``SeriesRing``, ``RobustDetector`` and ``TimeSeriesStore`` fed the same
  readings at the same instants (a scripted clock: gauges with an up and
  a down change point, a counter with a reset, a signal that is now and
  then unavailable, a provider that now and then raises) give JAX's
  ``series()`` at every tier, ``window_mean``, ``anomalies()``,
  ``watchdog_reasons()``, ``delta()`` across cursors, ``sparklines()``,
  ``tick_anatomy()``, ``memory_info()`` and ``statusz()``, and the same
  anomaly counter increments and log lines.
- ``register_default_signals`` over the port engine and over JAX's
  (``tiny``, float32, dense then paged): the same signal names, and equal
  readings of the engine signals with a backlog queued before the engine
  starts, then after the same 8-request burst under brownout level 1.
- ``hbm_occupancy`` on the CPU is the page pool's occupancy (None for a
  dense engine), as JAX's.
"""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import hbmz as jax_hbmz
from gofr_tpu.metrics import timeseries as jax_ts
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.slo import SLOTracker as JaxSLOTracker
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch import hbmz as pt_hbmz
from gofr_tpu_torch.metrics import timeseries as pt_ts
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.slo import SLOTracker
from gofr_tpu_torch.tpu.generate import GenerationEngine

PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1],
           [5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [2] * 12, [7, 7],
           [4, 4, 4], [1] * 15]
BUDGET = 10
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
CASES = {"dense": {}, "paged": dict(paged_kv=True, kv_page=4)}
ENGINE_SIGNALS = ("queue_depth", "batch_fill", "kv_free_pages",
                  "kv_occupancy", "brownout_level", "quarantine_total",
                  "queue_interactive", "queue_standard", "queue_batch")


class Calls:
    """A metrics sink and a logger that record every call."""

    def __init__(self):
        self.calls = []

    def increment_counter(self, name, **labels):
        self.calls.append(("counter", name, tuple(sorted(labels.items()))))

    def __getattr__(self, level):
        if level not in ("warn", "info", "error", "warning"):
            raise AttributeError(level)
        return lambda msg, *args: self.calls.append((level, msg % args))


def _script(n=480, seed=7):
    """Readings at ``now`` = 1000 + i / 2: a gauge that jumps up and comes
    back (watched up), one that falls off a cliff (watched down), a
    counter with a reset, a gauge that is unavailable every third
    sample, and a provider that raises every 50th."""
    rng = np.random.default_rng(seed)
    rows = []
    total = 0.0
    for i in range(n):
        gauge = float(rng.normal(10.0, 0.5)) + (25.0 if 300 <= i < 340
                                                 else 0.0)
        cliff = float(rng.normal(100.0, 2.0)) if i < 400 else 5.0
        total = 0.0 if i == 200 else total + float(rng.integers(0, 5))
        rows.append(dict(now=1000.0 + i / 2, gauge=gauge, cliff=cliff,
                         ctr=total,
                         sometimes=None if i % 3 == 0 else float(i % 7),
                         p1=float(rng.normal(0.5, 0.1)), p2=float(i),
                         raises=i % 50 == 0))
    return rows


def _store(mod, rows):
    """A store of ``mod`` over ``rows``, sampled at their instants, with a
    tick entry noted every 40th sample and a delta taken at the 400th.
    Returns (store, its metrics-and-log calls, the mid-run delta)."""
    calls = Calls()
    store = mod.TimeSeriesStore(metrics=calls, logger=calls, tick_sample=4,
                                tick_capacity=8)
    at = {"i": 0}

    def reading(name):
        return lambda: rows[at["i"]][name]

    def provider():
        row = rows[at["i"]]
        if row["raises"]:
            raise RuntimeError("provider down")
        return {"p1": row["p1"], "p2": row["p2"]}

    store.register("gauge", reading("gauge"), watch="up")
    store.register("cliff", reading("cliff"), watch="down")
    store.register("ctr", reading("ctr"), kind="counter")
    store.register("sometimes", reading("sometimes"), watch="both")
    store.register_provider(("p1", "p2"), provider,
                            kinds={"p2": "counter"}, watch={"p1": "up"})
    mid = None
    for i, row in enumerate(rows):
        at["i"] = i
        store.sample(now=row["now"])
        if i % 40 == 0:
            store.note_tick({"admission_s": i / 1000.0,
                             "host_dispatch_s": i / 500.0,
                             "kind": "tick", "batch": i % 4, "step": i})
        if i == 400:
            mid = store.delta()
    return store, calls.calls, mid


@pytest.fixture(scope="module")
def stores():
    rows = _script()
    return {"jax": _store(jax_ts, rows), "port": _store(pt_ts, rows),
            "now": rows[-1]["now"]}


def test_tiers_and_capacities_are_jax():
    assert pt_ts.TIERS == jax_ts.TIERS
    assert pt_ts.MAX_BUCKETS_PER_SIGNAL == jax_ts.MAX_BUCKETS_PER_SIGNAL
    assert (pt_ts.DELTA_LOG_CAPACITY, pt_ts.DELTA_MAX_SAMPLES) \
        == (jax_ts.DELTA_LOG_CAPACITY, jax_ts.DELTA_MAX_SAMPLES)


@pytest.mark.parametrize("tier", ["1s", "10s", "60s"])
@pytest.mark.parametrize("limit", [None, 20])
def test_series_of_every_tier_as_jax(stores, tier, limit):
    jax_store, port_store = stores["jax"][0], stores["port"][0]
    got = port_store.series(tier, limit=limit)
    assert got == jax_store.series(tier, limit=limit)
    assert len(got["t"]) > 1
    assert port_store.sparklines(tier) == jax_store.sparklines(tier)
    with pytest.raises(ValueError, match="unknown tier"):
        port_store.series("5s")


def test_window_means_anomalies_and_reasons_as_jax(stores):
    jax_store, port_store = stores["jax"][0], stores["port"][0]
    now = stores["now"]
    for name in ("gauge", "cliff", "ctr", "sometimes", "p1", "p2", "none"):
        for window in (5.0, 30.0, 300.0, 3600.0, 14400.0):
            assert port_store.window_mean(name, window, now) \
                == jax_store.window_mean(name, window, now), (name, window)
    anomalies = port_store.anomalies()
    assert anomalies == jax_store.anomalies()
    states = {(e["signal"], e["state"], e["direction"])
              for e in anomalies["recent"]}
    assert ("gauge", "raised", "up") in states
    assert ("gauge", "cleared", "up") in states
    assert ("cliff", "raised", "down") in states
    reasons = port_store.watchdog_reasons()
    assert reasons == jax_store.watchdog_reasons()
    assert any("cliff down" in reason for reason in reasons)
    # the anomaly counter and the log lines, call for call
    assert stores["port"][1] == stores["jax"][1]
    assert ("counter", "app_tpu_anomaly_total",
            (("direction", "down"), ("signal", "cliff"))) in stores["port"][1]


def test_delta_across_cursors_as_jax(stores):
    jax_store, port_store = stores["jax"][0], stores["port"][0]
    assert stores["port"][2] == stores["jax"][2]
    cursor = stores["port"][2]["cursor"]
    for c in (None, cursor, cursor + 50, 10, 10 ** 6):
        assert port_store.delta(c) == jax_store.delta(c), c
    assert port_store.delta(cursor)["reset"] is False
    assert port_store.delta(10 ** 6)["reset"] is True


def test_tick_anatomy_memory_and_statusz_as_jax(stores):
    jax_store, port_store = stores["jax"][0], stores["port"][0]
    for limit in (32, 3):
        assert port_store.tick_anatomy(limit) == jax_store.tick_anatomy(limit)
    assert port_store.tick_anatomy()["recorded"] == 8
    assert port_store.memory_info() == jax_store.memory_info()
    assert port_store.statusz() == jax_store.statusz()
    assert port_store.signals() == jax_store.signals()


def test_detector_and_ring_alone_as_jax():
    rng = np.random.default_rng(3)
    values = np.concatenate([rng.normal(1.0, 0.1, 60), np.full(10, 9.0),
                             rng.normal(1.0, 0.1, 20)])
    out = {}
    for name, mod in (("jax", jax_ts), ("port", pt_ts)):
        ring = mod.SeriesRing(1.0, 600)
        detector = mod.RobustDetector(threshold=4.0, min_baseline=10,
                                      guard=2, trigger_after=2,
                                      clear_after=3)
        events = []
        for i, value in enumerate(values):
            ring.add(float(value), float(i))
            events.append(detector.observe(float(value), ring, float(i)))
        out[name] = (events, ring.points(), ring.means(5),
                     ring.window_mean(12.0, 89.0), detector.last_z)
    assert out["port"] == out["jax"]
    assert any(e and e["state"] == "raised" for e in out["port"][0])


def test_sampler_runs_on_the_loop():
    """``start()`` samples on the loop at its interval; ``stop()`` ends
    the task (JAX's lifecycle)."""
    async def run():
        store = pt_ts.TimeSeriesStore(interval_s=0.05)
        store.register("one", lambda: 1.0)
        store.start()
        await asyncio.sleep(0.4)
        await store.stop()
        return store
    store = asyncio.run(run())
    assert store.statusz()["samples"] >= 3
    assert store._task is None


# -- the default signals over the engines ---------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _engine(package, weights, kw, slo=None):
    if package == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        return JaxEngine(jcfg, weights, slo=slo, **dict(ENGINE_KW, **kw))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                            device="cpu", slo=slo, **dict(ENGINE_KW, **kw))


def _signals_run(package, weights, case):
    """Default signals over a fresh engine of ``package``: sampled with
    6 requests queued before start (max_slots 2), then after the burst
    under brownout level 1. Returns (names, backlog reading, final
    reading, the tokens)."""
    mod, tracker = ((jax_ts, JaxSLOTracker) if package == "jax"
                    else (pt_ts, SLOTracker))
    kw = dict(CASES[case], max_slots=2)
    engine = _engine(package, weights, kw, slo=tracker())
    store = mod.TimeSeriesStore()
    mod.register_default_signals(store, slo=engine.slo, tpu=engine,
                                 container=SimpleNamespace(tpu=engine))

    async def run():
        tasks = [asyncio.ensure_future(engine.generate(p, BUDGET))
                 for p in PROMPTS[:6]]
        for _ in range(5):
            await asyncio.sleep(0)
        backlog = store.sample(now=10.0)
        await engine.start()
        try:
            tokens = await asyncio.wait_for(asyncio.gather(*tasks), 120.0)
        finally:
            await engine.stop()
        engine.set_brownout(1)
        store.sample(now=11.0)
        final = store.sample(now=12.0)
        return backlog, final, tokens
    backlog, final, tokens = asyncio.run(run())
    return store.signals(), backlog, final, tokens


@pytest.fixture(scope="module")
def signal_runs(weights):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = {pkg: _signals_run(pkg, weights, case)
                           for pkg in ("jax", "port")}
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_default_signal_names_as_jax(signal_runs, case):
    runs = signal_runs(case)
    assert runs["port"][0] == runs["jax"][0]
    assert set(ENGINE_SIGNALS) | {"raw_tok_s", "goodput_tok_s",
                                  "fault_injected_total",
                                  "hbm_occupancy"} <= set(runs["port"][0])
    assert runs["port"][3] == runs["jax"][3]


@pytest.mark.parametrize("case", list(CASES))
def test_default_signals_read_a_backlog_as_jax(signal_runs, case):
    """The port's ``stats()`` carries JAX's ``queue_depth``: six requests
    queued before the engine starts read 6 in both stores."""
    runs = signal_runs(case)
    port, jax_ = runs["port"][1], runs["jax"][1]
    assert port["queue_depth"] == jax_["queue_depth"] == 6.0
    for name in ENGINE_SIGNALS + ("hbm_occupancy",):
        assert port.get(name) == jax_.get(name), name


@pytest.mark.parametrize("case", list(CASES))
def test_default_signals_after_a_burst_as_jax(signal_runs, case):
    runs = signal_runs(case)
    port, jax_ = runs["port"][2], runs["jax"][2]
    for name in ENGINE_SIGNALS + ("hbm_occupancy",):
        assert port.get(name) == jax_.get(name), name
    assert port["brownout_level"] == 1.0
    assert ("kv_free_pages" in port) == (case == "paged")


@pytest.mark.parametrize("case", list(CASES))
def test_hbm_occupancy_on_the_cpu_is_the_pool_occupancy(weights, case):
    jax_engine = _engine("jax", weights, CASES[case])
    port_engine = _engine("port", weights, CASES[case])
    ids = []
    if case == "paged":
        ids = [engine._pool.alloc(5) for engine in (jax_engine, port_engine)]
    got = pt_hbmz.hbm_occupancy(SimpleNamespace(tpu=port_engine))
    assert got == jax_hbmz.hbm_occupancy(SimpleNamespace(tpu=jax_engine))
    if case == "paged":
        assert got == 5 / port_engine._pool.num_pages
        for engine, pages in zip((jax_engine, port_engine), ids):
            engine._pool.release(pages)
    else:
        assert got is None
    assert pt_hbmz.hbm_occupancy(SimpleNamespace(tpu=None)) is None
