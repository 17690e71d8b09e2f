"""Port parity for the operating-point auto-tuner
(``gofr_tpu_torch/tpu/autotune.py``) and the guard stack it shares with the
autoscaler (``tpu/fleet.GuardedActuator``) against the JAX package on the
CPU, the counterparts of ``tests/test_autotune.py`` (all but the
``/debug/tunez`` page, which is app wiring; the engine's half is
``tests/test_torch_operating_point.py``):

- the guard's streaks, cooldown and compile guard, step for step;
- ``OperatingPoint``'s snapshot, copy, dict, equality and repr;
- the stub-engine matrix: both packages' tuners over the same stub give
  the same ledger (results, reasons, points, scores) and apply the same
  points — hysteresis, cooldown, brownout, fast burn, compile storm, no
  trace, the min-gain floor, rollback, a clean probation, a blocked
  rollback, the forced-worst chaos pick;
- ``_candidates`` on real engines (dense, paged, speculative) equals
  JAX's on the same state, but for the staging-depth candidate: JAX's
  rule toggles 1 ↔ 2 from its live depth 1, the port's live depth is its
  rings' ``max_inflight_ticks + 1`` (3), so the same rule proposes 1;
- ``new_autotuner`` is opt-in, with JAX's keys and defaults, over a
  duck-typed config;
- the real-engine loop of ``scripts/autotune_smoke.py`` (a dense
  ``tiny``, one bucket of 64, one step a tick) on both packages' engines
  with real shadow replay: the same points applied in the same order,
  scores equal to 1e-12, no serving compile, and a forced worst pick
  rolled back;
- two replay scorings of the same (point, trace) give the same score,
  and it is JAX's.
"""

import asyncio
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import autotune as jax_autotune
from gofr_tpu.tpu import faults as jax_faults
from gofr_tpu.tpu import fleet as jax_fleet
from gofr_tpu.tpu import workload as jax_workload
from gofr_tpu.tpu.flightrecorder import RequestRecord as JaxRecord
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import autotune as pt_autotune
from gofr_tpu_torch.tpu import faults as pt_faults
from gofr_tpu_torch.tpu import fleet as pt_fleet
from gofr_tpu_torch.tpu import workload as pt_workload
from gofr_tpu_torch.tpu.flightrecorder import RequestRecord as PortRecord
from gofr_tpu_torch.tpu.generate import GenerationEngine

PKGS = {
    "jax": SimpleNamespace(autotune=jax_autotune, faults=jax_faults,
                           fleet=jax_fleet, workload=jax_workload,
                           Record=JaxRecord),
    "port": SimpleNamespace(autotune=pt_autotune, faults=pt_faults,
                            fleet=pt_fleet, workload=pt_workload,
                            Record=PortRecord),
}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    jax_faults.reset()
    pt_faults.reset()


# -- GuardedActuator -------------------------------------------------------------

def _guard_steps(pkg):
    Guard = PKGS[pkg].fleet.GuardedActuator
    out = []
    guard = Guard(up_after=2, down_after=3)
    for pressure, idle in ((True, False), (True, False), (False, False),
                           (False, True), (False, True), (False, True)):
        guard.observe(pressure, idle)
        out.append((guard.want_up(), guard.want_down(), guard.up_streak,
                    guard.down_streak))
    guard = Guard(up_after=1, cooldown_s=60.0)
    out.append(guard.refusal(now=100.0))
    guard.observe(True, False)
    guard.fired(now=100.0, direction="up")
    out += [guard.up_streak, guard.refusal(now=130.0),
            guard.refusal(now=161.0), guard.status()]
    guard.observe(False, True)
    guard.fired(now=200.0, direction="down")
    out.append(guard.status())
    ledger = SimpleNamespace(serving_compiles=lambda window_s: 2)
    guard = Guard(compile_ledger=ledger)
    out.append(guard.refusal(now=0.0))
    ledger.serving_compiles = lambda window_s: 0
    out.append(guard.refusal(now=0.0))
    return out


def test_guard_streaks_cooldown_and_compile_ledger_as_jax():
    out = _guard_steps("jax")
    assert _guard_steps("port") == out
    assert out[1][0] and not out[2][0] and out[5][1]
    assert out[6:10] == [None, 0, "cooldown", None]
    assert out[-2:] == ["compile_guard", None]


# -- OperatingPoint ----------------------------------------------------------------

def _point_ops(pkg):
    OP = PKGS[pkg].autotune.OperatingPoint
    engine = _StubEngine()
    live = OP.from_engine(engine)
    moved = live.replace(prompt_buckets=(16, 8, 8), note="x")
    other = OP(prompt_buckets=[8, 16], steps_per_tick="4", slots_cap=2,
               source="rollback", note="n")
    return [live.to_dict(), repr(live), moved.to_dict(), repr(moved),
            other.to_dict(), moved == live, live == OP.from_engine(engine),
            other == other.replace(), live.__eq__(object()),
            list(OP.__slots__)]


def test_operating_point_as_jax():
    assert _point_ops("port") == _point_ops("jax")


# -- the controller over a stub engine --------------------------------------------

class _StubEngine:
    """Duck-types exactly the engine surface the tuner consumes (JAX's
    test stub)."""

    def __init__(self):
        self.prompt_buckets = (64,)
        self.steps_per_tick = 1
        self.max_len = 64
        self.max_slots = 4
        self.spec = False
        self.paged = False
        self.kv_page = 1
        self._brownout = 0
        self._generation = 0
        self._source = "seed"
        self.applied = []
        self.prewarmed = []

    def operating_point(self):
        return {"prompt_buckets": list(self.prompt_buckets),
                "steps_per_tick": self.steps_per_tick,
                "gamma_cap": 0, "kv_reserve": None,
                "class_weights": {"batch": 1.0}, "slots_cap": None,
                "staging_depth": 1, "max_slots": self.max_slots,
                "source": self._source, "generation": self._generation,
                "applied_at": None}

    def xlaz(self, **kwargs):
        return {"models": {"prompt": {"suggested_ladder": [8, 16]}}}

    async def prewarm_operating_point(self, point):
        self.prewarmed.append(point)
        return {"compiled": 0}

    def apply_operating_point(self, point, source="autotune"):
        if self._brownout > 0:
            raise RuntimeError("brownout active")
        if point.prompt_buckets is not None:
            self.prompt_buckets = tuple(point.prompt_buckets)
        if point.steps_per_tick is not None:
            self.steps_per_tick = point.steps_per_tick
        self._generation += 1
        self._source = source
        self.applied.append((source, point))
        return self.operating_point()

    def serving_compiles(self, window_s=60.0, now=None):
        return 0


def _trace(n=8):
    events = [SimpleNamespace(prompt_len=8, output_len=4, budget=4)
              for _ in range(n)]
    return SimpleNamespace(events=events)


def _tuner(pkg, engine, **kwargs):
    kwargs.setdefault("improve_after", 1)
    kwargs.setdefault("cooldown_s", 0.0)
    kwargs.setdefault("min_trace_events", 1)
    kwargs.setdefault("trace_fn", _trace)
    kwargs.setdefault(
        "score_fn",
        lambda point, trace: 10.0
        if point.prompt_buckets == (8, 16) else 1.0)
    clock = iter(range(10 ** 6))
    kwargs.setdefault("now_fn", lambda: float(next(clock)))
    return PKGS[pkg].autotune.AutoTuner(engine, **kwargs)


def _stub_scenario(pkg, name):
    """One of JAX's stub tests as (firing results, engine state)."""
    engine = _StubEngine()
    goodput = {"value": 100.0}
    results = []

    def fire(tuner):
        results.append(asyncio.run(tuner())["result"])

    if name == "hysteresis":
        tuner = _tuner(pkg, engine, improve_after=2)
        fire(tuner)
        fire(tuner)
    elif name == "cooldown":
        tuner = _tuner(pkg, engine, cooldown_s=3600.0, probation_ticks=0)
        fire(tuner)
        fire(tuner)
    elif name == "refusals":
        engine._brownout = 2
        fire(_tuner(pkg, engine))
        engine._brownout = 0
        fire(_tuner(pkg, engine, fast_burn_fn=lambda: True))
        tuner = _tuner(pkg, engine, compile_source=SimpleNamespace(
            serving_compiles=lambda window_s: 3))
        fire(tuner)
    elif name == "no_trace":
        tuner = _tuner(pkg, engine, trace_fn=lambda: _trace(0))
        fire(tuner)
    elif name == "min_gain":
        tuner = _tuner(pkg, engine, score_fn=lambda point, trace: 1.0,
                       min_gain_pct=5.0)
        fire(tuner)
    elif name == "rollback":
        tuner = _tuner(pkg, engine, probation_ticks=3, regress_pct=10.0,
                       goodput_fn=lambda: goodput["value"])
        fire(tuner)
        goodput["value"] = 50.0
        fire(tuner)
    elif name == "probation_clean":
        tuner = _tuner(pkg, engine, probation_ticks=2, cooldown_s=3600.0,
                       goodput_fn=lambda: goodput["value"])
        for _ in range(3):
            fire(tuner)
    elif name == "rollback_blocked":
        tuner = _tuner(pkg, engine, probation_ticks=3,
                       brownout_fn=lambda: 0,
                       goodput_fn=lambda: goodput["value"])
        fire(tuner)
        goodput["value"] = 10.0
        engine._brownout = 1
        fire(tuner)
        engine._brownout = 0
        fire(tuner)
    elif name == "forced_worst":
        faults = PKGS[pkg].faults
        faults.install(faults.FaultPlan(PKGS[pkg].autotune.FAULT_SITE_SELECT))
        try:
            tuner = _tuner(pkg, engine)
            fire(tuner)
        finally:
            faults.install(None)
    ledger = [{k: v for k, v in event.items()} for event in tuner.ledger()]
    status = tuner.status()
    return {"results": results, "ledger": ledger,
            "applied": [(source, point.to_dict())
                        for source, point in engine.applied],
            "prewarmed": [point.to_dict() for point in engine.prewarmed],
            "buckets": engine.prompt_buckets,
            "status": {k: status[k] for k in ("applies", "rollbacks",
                                              "probation", "guard")}}


STUB_RESULTS = {
    "hysteresis": ["hold", "applied"],
    "cooldown": ["applied", "cooldown"],
    "refusals": ["refused_brownout", "refused_fast_burn", "compile_guard"],
    "no_trace": ["no_trace"],
    "min_gain": ["rejected"],
    "rollback": ["applied", "rolled_back"],
    "probation_clean": ["applied", "probation", "cooldown"],
    "rollback_blocked": ["applied", "rollback_blocked", "rolled_back"],
    "forced_worst": ["applied"],
}


@pytest.mark.parametrize("name", list(STUB_RESULTS))
def test_stub_matrix_as_jax(name):
    jax_run = _stub_scenario("jax", name)
    assert _stub_scenario("port", name) == jax_run
    assert jax_run["results"] == STUB_RESULTS[name]
    if name == "hysteresis":
        assert jax_run["ledger"][0]["reason"] == "hysteresis"
        assert jax_run["buckets"] == (8, 16)
        assert jax_run["prewarmed"][0]["prompt_buckets"] == [8, 16]
    if name == "min_gain":
        assert "min-gain" in jax_run["ledger"][-1]["reason"]
    if name in ("rollback", "rollback_blocked"):
        assert jax_run["applied"][-1][0] == "rollback"
        assert jax_run["buckets"] == (64,)
        assert jax_run["status"]["rollbacks"] == 1
    if name == "forced_worst":
        assert jax_run["ledger"][-1]["forced"] is True
        assert jax_run["buckets"] != (8, 16)


class _FailingPrewarm(_StubEngine):
    """A stub whose prewarm raises ``error`` from its ``fail_at``-th call
    on (the first is the apply's, the second the rollback's)."""

    def __init__(self, error, fail_at):
        super().__init__()
        self.error, self.fail_at = error, fail_at

    async def prewarm_operating_point(self, point):
        self.prewarmed.append(point)
        if len(self.prewarmed) >= self.fail_at:
            raise self.error
        return {"compiled": 0}


def _failing_prewarm_run(pkg, error, fail_at):
    """Fire the tuner until its prewarm fails: at the apply (``fail_at``
    1) or at the rollback after a goodput collapse (2)."""
    engine = _FailingPrewarm(error, fail_at)
    goodput = {"value": 100.0}
    tuner = _tuner(pkg, engine, probation_ticks=3,
                   goodput_fn=lambda: goodput["value"])
    results = [asyncio.run(tuner())["result"]]
    if fail_at == 2:
        goodput["value"] = 10.0
        results.append(asyncio.run(tuner())["result"])
    return (results, tuner.ledger()[-1].get("reason"),
            [(source, point.to_dict()) for source, point in engine.applied])


@pytest.mark.parametrize("fail_at,refused", [(1, "rejected"),
                                             (2, "rollback_blocked")])
def test_prewarm_refusal_is_noted_and_a_capture_failure_raises(fail_at,
                                                               refused):
    """A prewarm refusal (``ValueError``) is noted as JAX notes it; a
    prewarm ``RuntimeError`` (a failed graph capture on the card) raises
    out of the firing, where JAX's tuner notes it as a refusal — the
    port's one divergence here, stated in ``autotune``'s docstring."""
    refusal = ValueError("prewarm: prompt buckets [8] out of range")
    jax_run = _failing_prewarm_run("jax", refusal, fail_at)
    assert _failing_prewarm_run("port", refusal, fail_at) == jax_run
    assert jax_run[0][-1] == refused and "out of range" in jax_run[1]
    capture = RuntimeError("CUDA error: operation not permitted when "
                           "stream is capturing")
    assert _failing_prewarm_run("jax", capture, fail_at)[0][-1] == refused
    with pytest.raises(RuntimeError, match="stream is capturing"):
        _failing_prewarm_run("port", capture, fail_at)


def test_new_autotuner_is_opt_in_with_jax_defaults():
    class _Config(dict):
        def get(self, key, default=None):
            return dict.get(self, key, default)

        def get_bool(self, key, default=False):
            raw = self.get(key)
            return default if raw is None else \
                str(raw).lower() in ("1", "true", "yes", "on")

        def get_int(self, key, default=0):
            return int(self.get(key, default))

        def get_float(self, key, default=0.0):
            return float(self.get(key, default))

    def knobs(tuner):
        return [tuner.guard.up_after, tuner.guard.down_after,
                tuner.guard.cooldown_s, tuner.guard.compile_window_s,
                tuner.min_gain_pct, tuner.probation_ticks,
                tuner.regress_pct, tuner.max_candidates,
                tuner.min_trace_events, tuner.max_steps_per_tick,
                tuner.signal_window_s, tuner.replay_seed]

    moved = _Config(AUTOTUNE_ENABLED="1", AUTOTUNE_IMPROVE_AFTER="3",
                    AUTOTUNE_COOLDOWN_S="7", AUTOTUNE_COMPILE_WINDOW_S="9",
                    AUTOTUNE_MIN_GAIN_PCT="2.5",
                    AUTOTUNE_PROBATION_TICKS="5",
                    AUTOTUNE_REGRESS_PCT="20", AUTOTUNE_MAX_CANDIDATES="2",
                    AUTOTUNE_MIN_TRACE_EVENTS="4", AUTOTUNE_MAX_STEPS="16")
    out = {}
    for pkg in PKGS:
        factory = PKGS[pkg].autotune.new_autotuner
        engine = _StubEngine()
        assert factory(_Config(), engine) is None          # default OFF
        assert factory(None, engine) is None
        assert factory(_Config(AUTOTUNE_ENABLED="true"), None) is None
        assert factory(_Config(AUTOTUNE_ENABLED="true"), object()) is None
        tuner = factory(_Config(AUTOTUNE_ENABLED="true"), engine)
        assert isinstance(tuner, PKGS[pkg].autotune.AutoTuner)
        # the engine's own compile accounting is the guard's ledger
        assert tuner.guard.compile_ledger is engine
        ledger = SimpleNamespace(serving_compiles=lambda window_s: 0)
        engine.ledger = ledger
        assert factory(_Config(AUTOTUNE_ENABLED="true"),
                       engine).guard.compile_ledger is ledger
        out[pkg] = (knobs(tuner), knobs(factory(moved, engine)))
    assert out["port"] == out["jax"]
    assert out["jax"][0] == [2, 2, 300.0, 120.0, 5.0, 3, 10.0, 4, 16, 8,
                             60.0, 0x5EED]


# -- candidates on real engines ----------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_params(weights):
    return from_jax_llama(weights, "cpu")


def _engine(pkg, weights, port_params, **kw):
    if pkg == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        if kw.pop("spec", False):
            kw.update(draft_cfg=jcfg, draft_params=weights, spec_gamma=4)
        return JaxEngine(jcfg, weights, **kw)
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    if kw.pop("spec", False):
        kw.update(draft_cfg=tcfg, draft_params=port_params, spec_gamma=4)
    return GenerationEngine(tcfg, port_params, device="cpu", **kw)


def _recorder(pkg, lengths, model="generate", budget=3):
    mods = PKGS[pkg]
    rec = mods.workload.TrafficRecorder(capacity=64)
    for i, length in enumerate(lengths):
        record = mods.Record(model=model, prompt_len=length, budget=budget)
        rec.admit(record, "standard", now=10.0 + i * 0.002)
        record.tokens = budget
        record.status = "done"
        rec.finish(record)
    return rec


CANDIDATE_CASES = {
    "dense": dict(max_slots=4, max_len=64, prompt_buckets=(64,)),
    "paged": dict(max_slots=4, max_len=64, prompt_buckets=(16, 32),
                  paged_kv=True, kv_page=4, steps_per_tick=4),
    "spec": dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 spec=True, steps_per_tick=2),
}


@pytest.mark.parametrize("case", list(CANDIDATE_CASES))
def test_candidates_are_jax_but_the_staging_depth(weights, port_params,
                                                  case):
    out = {}
    for pkg in PKGS:
        engine = _engine(pkg, weights, port_params, **CANDIDATE_CASES[case])
        engine.attach_workload(_recorder(pkg, [3, 5, 7, 9, 3, 5, 11, 20]))
        tuner = PKGS[pkg].autotune.AutoTuner(engine)
        points = [p.to_dict() for p in tuner._candidates()]
        out[pkg] = (points, engine.operating_point()["staging_depth"])
    (jax_points, jax_depth), (port_points, port_depth) = \
        out["jax"], out["port"]
    # the stated divergence: JAX's live depth is 1, the port's its
    # rings' max_inflight_ticks + 1, and the toggle reads from there
    assert (jax_depth, port_depth) == (1, 3)
    staging = [i for i, p in enumerate(jax_points)
               if p["note"] == "staging depth toggle"]
    assert staging == [i for i, p in enumerate(port_points)
                       if p["note"] == "staging depth toggle"]
    assert jax_points[staging[0]]["staging_depth"] == 2
    assert port_points[staging[0]]["staging_depth"] == 1
    assert all(p["staging_depth"] == 1 for i, p in enumerate(jax_points)
               if i != staging[0])
    assert all(p["staging_depth"] == 3 for i, p in enumerate(port_points)
               if i != staging[0])

    def apart(points):
        return [{k: v for k, v in p.items() if k != "staging_depth"}
                for p in points]
    assert apart(port_points) == apart(jax_points)
    notes = [p["note"] for p in jax_points]
    assert notes[0] == "xlaz suggested ladder"
    if case == "paged":
        assert "kv reserve +" in notes
    if case == "spec":
        assert "gamma cap -1" in notes


# -- shadow replay on real engines ----------------------------------------------------

def _recorded_trace(pkg, n=6):
    rec = _recorder(pkg, [3 + (i % 3) for i in range(n)])
    return PKGS[pkg].workload.load_trace(json.dumps(rec.export_trace()))


def test_replay_scored_selection_is_deterministic_as_jax(weights,
                                                         port_params):
    """The default scoring path (shadow replay + the host cost model)
    gives the same score twice for the same (point, trace), and JAX's;
    the tighter ladder beats the detuned one."""
    out = {}
    for pkg in PKGS:
        mods = PKGS[pkg].autotune
        engine = _engine(pkg, weights, port_params, max_slots=4, max_len=64,
                         prompt_buckets=(8, 16))
        tuner = mods.AutoTuner(engine, min_trace_events=1)
        trace = _recorded_trace(pkg)
        tight = mods.OperatingPoint(prompt_buckets=(8,), steps_per_tick=2)
        detuned = mods.OperatingPoint(prompt_buckets=(64,),
                                      steps_per_tick=1)

        async def scores():
            return [await tuner._score_point(tight, trace),
                    await tuner._score_point(tight, trace),
                    await tuner._score_point(detuned, trace)]
        out[pkg] = asyncio.run(scores())
    assert out["port"] == out["jax"]
    one, two, worse = out["jax"]
    assert one == two > 0.0 and worse < one


# JAX's smoke prompts are 3-9 tokens; one length keeps the suggested
# ladder (and what each JAX shadow engine compiles) small while every step
# of the loop runs
SMOKE_PROMPTS = [list(range(1 + i % 2, 7 + i % 2)) for i in range(12)]


async def _smoke_loop(pkg, weights, port_params):
    """``scripts/autotune_smoke.py``'s loop on one package's engine."""
    mods = PKGS[pkg]
    engine = _engine(pkg, weights, port_params, max_slots=4, max_len=64,
                     prompt_buckets=(64,), steps_per_tick=1)
    recorder = mods.workload.TrafficRecorder(capacity=128)
    engine.attach_workload(recorder)
    compiles = []

    async def serve():
        await asyncio.gather(*[asyncio.wait_for(engine.generate(
            p, max_new_tokens=3, eos_id=None), 60.0) for p in SMOKE_PROMPTS])
        compiles.append(engine.serving_compiles(window_s=3600.0))

    def note(event):
        return {k: event.get(k) for k in ("result", "point", "score",
                                          "baseline", "forced", "reason")}

    await engine.warmup(prompt_counts=(1, 2, 4))
    await engine.start()
    try:
        await serve()
        seed_point = engine.operating_point()
        goodput = {"value": 100.0}
        tuner = mods.autotune.AutoTuner(
            engine, workload=recorder, improve_after=1, cooldown_s=0.0,
            probation_ticks=1, min_trace_events=8,
            goodput_fn=lambda: goodput["value"])
        steps = [note(await tuner())]
        applied = engine.operating_point()
        for _ in range(8):
            steps.append(note(await tuner()))
            if steps[-1]["result"] not in ("applied", "probation"):
                break
        probation = tuner.status()["probation"]
        await serve()
        tuned = engine.operating_point()
        mods.faults.install(mods.faults.FaultPlan(
            mods.autotune.FAULT_SITE_SELECT))
        try:
            steps.append(note(await tuner()))
        finally:
            mods.faults.install(None)
        goodput["value"] = 5.0
        steps.append(note(await tuner()))
        restored = engine.operating_point()
        compiles.append(engine.serving_compiles(window_s=3600.0))
        proposed = [(e["point"], e["score"]) for e in tuner.ledger()
                    if e["result"] == "proposed"]

        def op(point):
            return {k: point[k] for k in ("prompt_buckets", "steps_per_tick",
                                          "source", "generation")}
        return {"steps": steps, "proposed": proposed,
                "seed": op(seed_point), "applied": op(applied),
                "tuned": op(tuned), "restored": op(restored),
                "probation": probation, "compiles": compiles,
                "rollbacks": tuner.status()["rollbacks"]}
    finally:
        await engine.stop()


def _apart(steps):
    """Each step without the staging depth its points carry (1 in JAX,
    3 in the port, the divergence above)."""
    def strip(point):
        return None if point is None else \
            {k: v for k, v in point.items() if k != "staging_depth"}
    return [dict(step, point=strip(step["point"])) for step in steps]


def test_smoke_loop_applies_jax_points_then_rolls_back(weights,
                                                       port_params):
    runs = {pkg: asyncio.run(_smoke_loop(pkg, weights, port_params))
            for pkg in PKGS}
    jax_run, port_run = runs["jax"], runs["port"]
    assert [s["result"] for s in port_run["steps"]] == \
        [s["result"] for s in jax_run["steps"]]
    for jax_step, port_step in zip(_apart(jax_run["steps"]),
                                   _apart(port_run["steps"])):
        for key in ("score", "baseline"):
            if jax_step[key] is not None:
                assert port_step[key] == pytest.approx(jax_step[key],
                                                       rel=0, abs=1e-12)
        assert {k: v for k, v in port_step.items()
                if k not in ("score", "baseline", "reason")} == \
            {k: v for k, v in jax_step.items()
             if k not in ("score", "baseline", "reason")}
    assert len(port_run["proposed"]) == len(jax_run["proposed"])
    for (jp, js), (pp, ps) in zip(jax_run["proposed"], port_run["proposed"]):
        assert ps == pytest.approx(js, rel=0, abs=1e-12)
        if jp["note"] != "staging depth toggle":
            assert _apart([{"point": pp}]) == _apart([{"point": jp}])
    for key in ("seed", "applied", "tuned", "restored", "probation",
                "compiles", "rollbacks"):
        assert port_run[key] == jax_run[key], key
    results = [s["result"] for s in jax_run["steps"]]
    assert results[0] == "applied" and results[-1] == "rolled_back"
    assert results[-3] in ("rejected", "hold")
    assert jax_run["steps"][0]["score"] > jax_run["steps"][0]["baseline"]
    assert jax_run["applied"]["source"] == "autotune"
    assert jax_run["applied"]["generation"] == 1
    assert max(jax_run["applied"]["prompt_buckets"]) < 64
    assert jax_run["steps"][-2]["forced"] is True
    assert jax_run["restored"]["source"] == "rollback"
    assert jax_run["restored"]["prompt_buckets"] == \
        jax_run["tuned"]["prompt_buckets"]
    assert jax_run["compiles"] == [0, 0, 0] and jax_run["rollbacks"] == 1
