"""Port parity for the engine's operating point (``operating_point``,
``prewarm_operating_point``, ``apply_operating_point``, ``shadow_clone``,
``slots_cap``) against the JAX engine on the CPU (``tiny``, float32).

The cases of the JAX package's own engine tests
(``tests/test_autotune.py``), each on the port engine and, where JAX has
the value, against JAX's. The point is a plain duck-typed object (the
JAX package's ``OperatingPoint`` comes with auto-tuning):

- every refusal (brownout, empty or out-of-range buckets, buckets off the
  page, a shape move not prewarmed, ``kv_reserve``, class weights and
  ``slots_cap`` out of range) raises JAX's error with JAX's message, and
  nothing is applied;
- prewarm, then apply: ``compiled`` counts one graph a prefill rung (JAX
  one prefill and one insert executable each) and a tick rung, each run
  once on the CPU; a second prewarm of the point runs nothing; no
  serving compile; moving back to the seed point needs no prewarm;
- a non-shape knob move while a decode is live leaves its tokens bit for
  bit as they were;
- ``slots_cap`` throttles admission (never more active slots than the
  cap) and strands no request, a cap lowered mid-burst too;
- ``operating_point()`` equals JAX's apart from ``applied_at`` (a clock)
  and ``staging_depth`` (the port's staging rings are
  ``max_inflight_ticks + 1`` deep), before and after the same apply;
- ``shadow_clone`` carries the candidate point, no hooks, the source's
  parameter tensors themselves (same storage), its own cache or pool,
  and serves the source's greedy tokens;
- after a move of k and buckets, greedy tokens equal JAX's after the same
  move, dense and paged, and a burst served while the move is prewarmed
  gives the tokens of the same burst with no prewarm.
"""

import asyncio
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.staging import StagingPool

ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)
CASES = {"dense": {}, "paged": dict(paged_kv=True, kv_page=4)}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3, 3, 3, 3, 1],
           [5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [2] * 12, [7, 7],
           [4, 4, 4], [1] * 15]
# after the move: one prompt only the new bucket 32 admits
MOVED_PROMPTS = PROMPTS[:5] + [list(range(1, 21)), [6] * 30, [8, 9]]
MOVE = SimpleNamespace(prompt_buckets=(8, 16, 32), steps_per_tick=8)
BUDGET = 10
# operating-point keys whose values are the port's own, with the reason
APART = {"applied_at": "a monotonic instant of each process",
         "staging_depth": "the port's staging rings are max_inflight_ticks "
                          "+ 1 deep, JAX's 1"}


def point(**knobs):
    return SimpleNamespace(**knobs)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _engine(package, weights, **kw):
    kw = dict(ENGINE_KW, **kw)
    if package == "jax":
        jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
        return JaxEngine(jcfg, weights, **kw)
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                            device="cpu", **kw)


def _comparable(op):
    return {k: v for k, v in op.items() if k not in APART}


# -- refusals -------------------------------------------------------------------

REFUSALS = {
    "empty_buckets": ({}, point(prompt_buckets=())),
    "bucket_out_of_range": ({}, point(prompt_buckets=(8, 4096))),
    "bucket_zero": ({}, point(prompt_buckets=(0, 8))),
    "bucket_off_the_page": (CASES["paged"], point(prompt_buckets=(8, 18))),
    "not_prewarmed": ({}, point(prompt_buckets=(8, 32), steps_per_tick=2)),
    "k_not_prewarmed": ({}, point(steps_per_tick=8)),
    "kv_reserve": (CASES["paged"], point(kv_reserve=10 ** 6)),
    "kv_reserve_negative": (CASES["paged"], point(kv_reserve=-1)),
    "class_weights": ({}, point(class_weights={"batch": -1.0,
                                               "standard": 0.0})),
    "slots_cap_high": ({}, point(slots_cap=99)),
    "slots_cap_zero": ({}, point(slots_cap=0)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_apply_refusals_are_jax(weights, case):
    kw, candidate = REFUSALS[case]
    errors = []
    for package in ("jax", "port"):
        engine = _engine(package, weights, **kw)
        before = _comparable(engine.operating_point())
        with pytest.raises((ValueError, RuntimeError)) as info:
            engine.apply_operating_point(candidate)
        errors.append((type(info.value), str(info.value)))
        assert _comparable(engine.operating_point()) == before
        assert engine.operating_point()["generation"] == 0
    assert errors[1] == errors[0]


def test_apply_refused_under_brownout_as_jax(weights):
    errors = []
    for package in ("jax", "port"):
        engine = _engine(package, weights)
        engine.set_brownout(2)
        with pytest.raises(RuntimeError, match="brownout") as info:
            engine.apply_operating_point(
                point(class_weights={"batch": 2.0}))
        errors.append(str(info.value))
        engine.set_brownout(0)
        engine.apply_operating_point(point(class_weights={"batch": 2.0}))
        assert engine.operating_point()["class_weights"] == {"batch": 2.0}
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case,buckets", [
    ("dense", (8, 4096)), ("dense", ()), ("paged", (8, 18))])
def test_prewarm_refusals_are_jax(weights, case, buckets):
    errors = []
    for package in ("jax", "port"):
        engine = _engine(package, weights, **CASES[case])
        with pytest.raises(ValueError) as info:
            asyncio.run(engine.prewarm_operating_point(
                point(prompt_buckets=buckets)))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# -- prewarm, then apply --------------------------------------------------------

def _prewarm_then_apply(package, weights, candidate):
    engine = _engine(package, weights)

    async def run():
        with pytest.raises(RuntimeError, match="not prewarmed"):
            engine.apply_operating_point(candidate)
        warm = await engine.prewarm_operating_point(candidate)
        again = await engine.prewarm_operating_point(candidate)
        applied = engine.apply_operating_point(candidate)
        # the outgoing shape stays prewarmed: moving back is free
        seed = engine.apply_operating_point(point(prompt_buckets=(8, 16),
                                                  steps_per_tick=4),
                                            source="rollback")
        return warm, again, applied, seed
    return engine, asyncio.run(run())


def test_prewarm_then_apply_as_jax(weights):
    candidate = point(prompt_buckets=(8, 32), steps_per_tick=2)
    jax_engine, (jwarm, jagain, japplied, jseed) = _prewarm_then_apply(
        "jax", weights, candidate)
    engine, (warm, again, applied, seed) = _prewarm_then_apply(
        "port", weights, candidate)
    # the port: one graph a prefill rung (2 buckets x counts 1, 2, 4) and a
    # tick rung (k 1 and 2, greedy and sampled), each run once on the CPU
    assert warm == {"compiled": 6 + 4, "prompt_buckets": [8, 32],
                    "steps_per_tick": 2}
    # JAX: a prefill and an insert executable a rung, and the same ticks
    assert jwarm["compiled"] == 2 * 6 + 4
    assert {k: v for k, v in warm.items() if k != "compiled"} \
        == {k: v for k, v in jwarm.items() if k != "compiled"}
    assert again["compiled"] == jagain["compiled"] == 0
    assert _comparable(applied) == _comparable(japplied)
    assert applied["generation"] == 1 and applied["source"] == "autotune"
    assert applied["prompt_buckets"] == [8, 32]
    assert _comparable(seed) == _comparable(jseed)
    assert seed["generation"] == 2 and seed["source"] == "rollback"
    assert engine._k_ladder == [1, 2, 4]
    assert engine.serving_compiles(window_s=3600.0) == 0
    assert engine.stats()["compiles"] == {"warmup": 0, "serving": 0}
    assert engine.xlaz()["operating_point"]["generation"] == 2


@pytest.mark.parametrize("case", list(CASES))
def test_operating_point_is_jax(weights, case):
    engines = {pkg: _engine(pkg, weights, **CASES[case])
               for pkg in ("jax", "port")}
    assert _comparable(engines["port"].operating_point()) \
        == _comparable(engines["jax"].operating_point())
    assert set(engines["port"].operating_point()) \
        == set(engines["jax"].operating_point())
    knobs = point(class_weights={"interactive": 8.0, "standard": 2.0,
                                 "batch": 1.0}, slots_cap=2, staging_depth=2,
                  gamma_cap=2, kv_reserve=3 if case == "paged" else None)
    for engine in engines.values():
        engine.apply_operating_point(knobs)
    port = engines["port"].operating_point()
    assert _comparable(port) == _comparable(engines["jax"].operating_point())
    assert port["staging_depth"] == engines["port"]._staging.depth == 2
    assert port["applied_at"] is not None
    assert engines["port"].xlaz()["operating_point"] == port


# -- live knob moves and slots_cap ----------------------------------------------

def test_non_shape_knob_move_is_bit_identical_for_a_live_decode(weights):
    engine = _engine("port", weights)
    prompt = list(range(1, 7))

    async def run():
        await engine.start()
        try:
            before = await engine.generate(prompt, 40)
            live = asyncio.ensure_future(engine.generate(prompt, 40))
            while not engine.active_slots:
                await asyncio.sleep(0.001)
            engine.apply_operating_point(point(
                class_weights={"interactive": 8.0, "standard": 2.0,
                               "batch": 1.0}, slots_cap=2, staging_depth=2))
            return before, await asyncio.wait_for(live, 60.0)
        finally:
            await engine.stop()
    before, after = asyncio.run(run())
    assert before == after and len(after) == 40
    assert engine.operating_point()["slots_cap"] == 2


def _capped(package, weights, cap, lower_to=None):
    """A burst of 8 on 4 slots under ``slots_cap`` ``cap`` (lowered to
    ``lower_to`` once the first slot is claimed). Returns the tokens and,
    for every admission pass that claimed a slot, (the cap then, the
    slots active after it)."""
    engine = _engine(package, weights)
    if cap is not None:
        engine.apply_operating_point(point(slots_cap=cap))
    passes = []
    admit = engine._admit_pending

    def watched(*args):
        before = engine.active_slots
        out = admit(*args)
        if engine.active_slots > before:
            passes.append((engine.slots_cap, engine.active_slots))
        return out

    async def run():
        await engine.start()
        try:
            tasks = [asyncio.ensure_future(engine.generate(p, BUDGET))
                     for p in PROMPTS]
            if lower_to is not None:
                while not engine.active_slots:
                    await asyncio.sleep(0.001)
                engine.apply_operating_point(point(slots_cap=lower_to))
            return await asyncio.wait_for(asyncio.gather(*tasks), 120.0)
        finally:
            await engine.stop()
    if package == "port":
        engine._admit_pending = watched
    return asyncio.run(run()), passes


@pytest.mark.parametrize("cap,lower_to", [(1, None), (2, None), (4, 1)])
def test_slots_cap_throttles_admission_without_stranding(weights, cap,
                                                         lower_to):
    tokens, passes = _capped("port", weights, cap, lower_to)
    jax_tokens, _ = _capped("jax", weights, cap, lower_to)
    assert tokens == jax_tokens
    assert all(len(t) == BUDGET for t in tokens)
    # no pass claims a slot past the cap in force
    assert passes and all(active <= cap_then for cap_then, active in passes)
    if lower_to is None:
        assert max(active for _, active in passes) == cap
    else:
        assert any(cap_then == lower_to for cap_then, _ in passes)


def test_admit_room_as_jax(weights):
    for cap in (None, 1, 2, 4):
        engines = [_engine(pkg, weights) for pkg in ("jax", "port")]
        for engine in engines:
            engine.slots_cap = cap
            engine._free = engine._free[:3]        # one slot taken
        for taken in range(5):
            assert engines[1]._admit_room(taken) \
                == engines[0]._admit_room(taken), (cap, taken)


# -- the shadow clone --------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree



def test_device_work_submitted_during_stop_is_refused(weights):
    """``stop()`` forgets the engine's device thread only once it has
    ended: a job submitted while it shuts down is refused, never run on a
    second thread beside the jobs still queued on the first."""
    engine = _engine("port", weights)

    async def run():
        await engine.start()
        own = engine._device_exec
        loop = asyncio.get_running_loop()
        gate = threading.Event()
        queued = loop.run_in_executor(own, gate.wait)
        stopping = loop.create_task(engine.stop())
        while not own._shutdown:
            await asyncio.sleep(0.001)
        assert engine._device_exec is own
        with pytest.raises(RuntimeError, match="after shutdown"):
            await loop.run_in_executor(engine._device_exec, int)
        gate.set()
        await queued
        await stopping
        names = [t.name for t in threading.enumerate()
                 if t.name.startswith("gofr-torch-device")]
        return own, names

    own, names = asyncio.run(run())
    assert engine._own_exec is None and names == []
    assert engine._device_exec is not own      # a new one at next use
    asyncio.run(engine.stop())


def test_lowered_staging_depth_shrinks_the_rings(monkeypatch):
    """An operating point's lower ``staging_depth`` takes effect: a ring
    grown to the old depth gives up its surplus slabs at its next upload,
    keeping one to reuse, and a raised depth lets it grow again. The
    rings' logic, on the CPU (plain host tensors stand in for pinned
    ones)."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **k: empty(*a, **k))
    pool = StagingPool(torch.device("cpu"), depth=5)
    key = ("up", (4,), torch.int32)
    slabs = [pool._acquire(key) for _ in range(5)]
    for slab in slabs:
        pool._release(key, slab)
    assert pool._count[key] == 5 and pool.stats()["slab_bytes"] == 80
    pool.depth = 1
    slab = pool._acquire(key)
    assert slab in slabs and pool._count[key] == 1
    assert pool.stats()["slab_bytes"] == 16 and not pool._free[key]
    pool._release(key, slab)
    assert pool._acquire(key) is slab and pool._count[key] == 1
    pool.depth = 3        # held out: the ring may grow again
    assert pool._acquire(key) is not slab and pool._count[key] == 2


@pytest.mark.parametrize("case", list(CASES))
def test_shadow_clone_shares_weights_and_carries_the_point(weights, case):
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    params = from_jax_llama(weights, "cpu")
    engine = GenerationEngine(tcfg, params, device="cpu", draft_cfg=tcfg,
                              draft_params=params, spec_gamma=2,
                              prefix_cache=True, prefix_page=4,
                              model_name="llm", **ENGINE_KW, **CASES[case])
    engine.attach_telemetry(SimpleNamespace(note_tick=lambda e: None))
    candidate = point(prompt_buckets=(8,), steps_per_tick=2,
                      class_weights={"batch": 3.0})
    shadow = engine.shadow_clone(candidate)
    assert shadow.prompt_buckets == (8,) and shadow.steps_per_tick == 2
    assert shadow.class_weights == {"batch": 3.0}
    assert shadow.model_name == "llm@shadow"
    assert shadow.device == engine.device
    assert (shadow.metrics, shadow.tracer, shadow.slo, shadow.telemetry,
            shadow.workload) == (None,) * 5
    assert shadow.recorder is not engine.recorder
    assert not shadow.spec and shadow._prefix is None
    assert shadow.paged == engine.paged
    pairs = list(zip(_leaves(shadow.params), _leaves(engine.params)))
    for clone_leaf, leaf in pairs:
        assert clone_leaf is leaf
        assert clone_leaf.data_ptr() == leaf.data_ptr()
    assert len(pairs) > 4
    if engine.paged:
        assert shadow._pool is not engine._pool
        assert shadow._pool.num_pages == engine._pool.num_pages
    else:
        assert all(shadow.cache[k].data_ptr() != engine.cache[k].data_ptr()
                   for k in engine.cache)
    # no point: the source's own
    plain = engine.shadow_clone()
    assert (plain.prompt_buckets, plain.steps_per_tick) \
        == (engine.prompt_buckets, engine.steps_per_tick)

    async def serve(e):
        await e.start()
        try:
            return await asyncio.gather(*[e.generate(p, BUDGET)
                                          for p in PROMPTS[:3]])
        finally:
            await e.stop()
    bare = GenerationEngine(tcfg, params, device="cpu", **ENGINE_KW,
                            **CASES[case])
    assert asyncio.run(serve(plain)) == asyncio.run(serve(bare))


# -- tokens after a move ------------------------------------------------------------

def _moved(package, weights, case, prewarm_during_burst=False):
    engine = _engine(package, weights, **CASES[case])

    async def run():
        await engine.start()
        try:
            burst = [asyncio.ensure_future(engine.generate(p, BUDGET))
                     for p in PROMPTS]
            if prewarm_during_burst:
                while not engine.active_slots:
                    await asyncio.sleep(0.001)
                warm = await engine.prewarm_operating_point(MOVE)
            first = await asyncio.wait_for(asyncio.gather(*burst), 120.0)
            if not prewarm_during_burst:
                warm = await engine.prewarm_operating_point(MOVE)
            engine.apply_operating_point(MOVE)
            second = await asyncio.wait_for(asyncio.gather(
                *[engine.generate(p, BUDGET) for p in MOVED_PROMPTS]), 120.0)
            return first, second, warm
        finally:
            await engine.stop()
    first, second, warm = asyncio.run(run())
    return first, second, warm, engine


@pytest.fixture(scope="module")
def moves(weights):
    cache = {}

    def get(case, package, during=False):
        if (case, package, during) not in cache:
            cache[case, package, during] = _moved(package, weights, case,
                                                  during)
        return cache[case, package, during]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_tokens_after_a_move_are_jax(moves, case):
    first, second, warm, engine = moves(case, "port")
    jfirst, jsecond, _, _ = moves(case, "jax")
    assert first == jfirst and second == jsecond
    assert all(len(t) == BUDGET for t in first + second)
    assert warm["steps_per_tick"] == 8 and warm["compiled"] > 0
    assert engine.operating_point()["prompt_buckets"] == [8, 16, 32]
    # k 8 ran after the move, at most 8 steps a tick
    assert engine._k_ladder == [1, 2, 4, 8]


@pytest.mark.parametrize("case", list(CASES))
def test_burst_during_a_prewarm_is_the_burst_without(moves, case):
    first, second, warm, _ = moves(case, "port", during=True)
    want_first, want_second, want_warm, _ = moves(case, "port")
    assert first == want_first and second == want_second
    assert warm["compiled"] > 0
