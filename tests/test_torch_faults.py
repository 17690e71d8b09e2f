"""Port parity for the fault plane (``tpu/faults.py``) and the engine's
two injection sites against the JAX package on the CPU (``tiny``,
float32).

- A seeded ``FaultPlan`` (spec grammar, ``arm``/``disarm``) decides as
  JAX's does over one sequence of arrivals at several sites, counts the
  same arrivals and fires, emits ``app_tpu_fault_injected_total`` per
  site and stamps ``fault.injected`` on the active span; the no-op
  singleton, ``install``/``reset``/``active`` and ``plan_from_env``
  behave as JAX's.
- ``nan_logits`` (the first participant's fetched tokens poisoned at
  publish) quarantines the same request as in the JAX engine, dense and
  paged, and the other requests' tokens equal JAX's.
- ``tick_exception`` (raised at the top of a tick's dispatch, taken by
  the loop's catch-all) fails the same requests as in the JAX engine;
  the requests still queued are served with JAX's tokens, and so is a
  later burst; no graph, buffer or page is lost.
- A deadline-expired, a cancelled and a quarantined request finish their
  flight records with JAX's statuses.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu import slo as jax_slo
from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import faults as jax_faults
from gofr_tpu.tpu.flightrecorder import FlightRecorder as JaxRecorder
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.trace import tracer as jax_tracer
from gofr_tpu_torch import slo as pt_slo
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import faults as pt_faults
from gofr_tpu_torch.tpu.flightrecorder import FlightRecorder
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.trace import tracer as pt_tracer

SITES = ("tick_exception", "nan_logits", "kv_chunk_corrupt", "broker_drop")
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1],
           [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]]
BUDGET = 10
ENGINE_KW = dict(max_len=64, prompt_buckets=(8, 16), steps_per_tick=4)
LAYOUTS = {"dense": {}, "paged": dict(paged_kv=True, kv_page=4)}


# -- the plan -------------------------------------------------------------------

def _decide(mod, tracer_mod, spec, seed, arrivals):
    metrics = (register_engine_metrics(Manager()) if mod is pt_faults
               else new_mock_container().metrics)
    plan = mod.FaultPlan(spec, seed=seed, metrics=metrics)
    plan.arm("broker_drop", nth=5)
    decisions = []
    tracer = tracer_mod.Tracer()
    with tracer.start_span("chaos") as span:
        for i, site in enumerate(arrivals):
            if i == len(arrivals) // 2:
                plan.disarm("kv_chunk_corrupt")
                plan.arm("tick_exception", prob=0.5)
            decisions.append(plan.should(site))
    series = {key: value for key, value in
              metrics.snapshot()["app_tpu_fault_injected_total"]
              .series.items()}
    events = [(e["attributes"]["site"], e["attributes"]["arrival"])
              for e in span.find_events("fault.injected")]
    return (decisions, plan.fired(), {s: plan.arrivals(s) for s in SITES},
            plan.seed, series, events)


@pytest.mark.parametrize("spec", [
    "seed=7,tick_exception:0.25,nan_logits:@3,kv_chunk_corrupt",
    "nan_logits:0.5, tick_exception:@1 ,",
    "",
])
@pytest.mark.parametrize("seed", [0, 11])
def test_plan_decides_as_jax(spec, seed):
    rng = np.random.default_rng(seed)
    arrivals = [SITES[int(i)] for i in rng.integers(0, len(SITES), 300)]
    want = _decide(jax_faults, jax_tracer, spec, seed, arrivals)
    got = _decide(pt_faults, pt_tracer, spec, seed, arrivals)
    assert got == want
    assert any(got[0]) and not all(got[0])


def test_module_plane_as_jax():
    for mod in (jax_faults, pt_faults):
        assert mod.active().enabled is False
        assert mod.active().should("nan_logits") is False
        assert mod.active().fired() == {} and mod.active().fired("x") == 0
        mod.active().raise_if("tick_exception")
        plan = mod.install(mod.FaultPlan("tick_exception"))
        try:
            assert mod.active() is plan
            with pytest.raises(mod.FaultError) as err:
                mod.active().raise_if("tick_exception")
            assert err.value.site == "tick_exception"
        finally:
            mod.reset()
        assert mod.active().enabled is False
        assert mod.install(None) is mod.active()
        assert mod.plan_from_env({}) is None
        env = mod.plan_from_env({"FAULT_PLAN": "seed=3,nan_logits:@2"})
        assert env.seed == 3 and [env.should("nan_logits")
                                  for _ in range(3)] == [False, True, False]
    assert issubclass(pt_faults.FaultError, RuntimeError)


# -- the engine's sites -----------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _engine(weights, package, max_slots=4, **kw):
    if package == "jax":
        container = new_mock_container()
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        return JaxEngine(jcfg, weights, logger=container.logger,
                         metrics=container.metrics, recorder=JaxRecorder(),
                         max_slots=max_slots, **ENGINE_KW, **kw)
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                            device="cpu", recorder=FlightRecorder(),
                            metrics=register_engine_metrics(Manager()),
                            max_slots=max_slots, **ENGINE_KW, **kw)


def _outcome(done):
    return [type(d).__name__ if isinstance(d, BaseException) else d
            for d in done]


def _serve_faulted(engine, mod, spec, prompts, after=None):
    """Serve ``prompts`` with ``spec`` installed, then ``after`` with no
    plan; returns both results and the plan's fires."""
    async def main():
        await engine.start()
        try:
            plan = mod.install(mod.FaultPlan(spec))
            try:
                done = await asyncio.wait_for(asyncio.gather(
                    *[engine.generate(p, BUDGET) for p in prompts],
                    return_exceptions=True), 120.0)
            finally:
                mod.reset()
            later = None
            if after is not None:
                later = await asyncio.wait_for(asyncio.gather(
                    *[engine.generate(p, BUDGET) for p in after]), 120.0)
            return done, later, plan.fired()
        finally:
            await engine.stop()
    return asyncio.run(main())


def _statuses(engine):
    """(status, prompt_len, tokens) of each record; a failed request's
    tokens are those that landed before its failure, which depends on
    when the host saw its fetch, so they are left out."""
    return sorted((r["status"], r["prompt_len"],
                   r["tokens"] if r["status"] == "done" else None)
                  for r in engine.recorder.snapshot()["recent"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_nan_logits_quarantines_jax_slot(weights, layout):
    runs = {}
    for package, mod in (("jax", jax_faults), ("port", pt_faults)):
        engine = _engine(weights, package, **LAYOUTS[layout])
        done, _, fired = _serve_faulted(engine, mod, "nan_logits:@2",
                                        PROMPTS)
        runs[package] = (_outcome(done), fired, _statuses(engine),
                         engine.stats()["resilience"]["quarantined"])
    assert runs["port"] == runs["jax"]
    outcome = runs["port"][0]
    assert outcome.count("RuntimeError") == 1
    assert runs["port"][3] == {"nan_logits": 1}
    assert [s for s, _, _ in runs["port"][2]].count("error") == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tick_exception_fails_bound_callers_and_serves_the_queue(weights,
                                                                 layout):
    """Two slots, four requests: the second tick's dispatch raises; the
    two requests bound to slots fail with ``FaultError``, the two still
    queued are served after the reset, and so is a later burst, all with
    JAX's tokens."""
    runs, engines = {}, {}
    for package, mod in (("jax", jax_faults), ("port", pt_faults)):
        engine = _engine(weights, package, max_slots=2, **LAYOUTS[layout])
        done, later, fired = _serve_faulted(
            engine, mod, "tick_exception:@2", PROMPTS, after=PROMPTS[:2])
        runs[package] = (_outcome(done), later, fired, _statuses(engine))
        engines[package] = engine
    assert runs["port"] == runs["jax"]
    outcome = runs["port"][0]
    assert outcome[:2] == ["FaultError", "FaultError"]
    assert all(isinstance(tokens, list) for tokens in outcome[2:])
    engine = engines["port"]
    assert engine.active_slots == 0 and not engine._publishq
    if engine.paged:
        assert engine.stats()["kv_pool"]["used_pages"] == 0


def _lifecycle(engine, slo_mod):
    """An expired request, a stream cancelled after its first token, a
    stream cancelled before admission, and a normal request."""
    async def main():
        await engine.start()
        try:
            slo_mod.set_request_deadline(1.0, now=0.0)   # long past
            try:
                await engine.generate(PROMPTS[0], BUDGET)
            except slo_mod.DeadlineExceeded:
                pass
            finally:
                slo_mod.set_request_deadline(None)
            stream = await engine.generate_stream(PROMPTS[1], BUDGET)
            first = await stream.__anext__()
            stream.cancel()
            await engine.stop()
            queued = await engine.generate_stream(PROMPTS[2], BUDGET)
            queued.cancel()
            await engine.start()
            served = await engine.generate(PROMPTS[3], BUDGET)
            return first, served
        finally:
            await engine.stop()
    return asyncio.run(main())


def test_expired_and_cancelled_records_as_jax(weights):
    runs = {}
    for package, mod in (("jax", jax_slo), ("port", pt_slo)):
        engine = _engine(weights, package)
        result = _lifecycle(engine, mod)
        runs[package] = (result, sorted(
            (r["status"], r["prompt_len"])
            for r in engine.recorder.snapshot()["recent"]))
    assert runs["port"] == runs["jax"]
    assert [s for s, _ in runs["port"][1]] == sorted(
        ["expired", "cancelled", "cancelled", "done"])
