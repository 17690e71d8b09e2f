"""Port parity for the retry policy (``gofr_tpu_torch/tpu/retry.py``) and
the chaos contracts of the disaggregated path, against the JAX package
(the counterparts of ``tests/test_chaos.py``'s retry, dedupe and chunk
fault cases), on the CPU (``tiny``, float32):

- attempts are bounded and the last error is kept as the cause; a
  non-retryable error surfaces at once;
- backoff is exponential with full jitter, the same ``random`` seed
  giving the same waits in both packages; a deadline cuts the loop;
  ``new_retry_policy`` reads JAX's knobs;
- a hedged backup races a slow primary, first success winning;
- a replayed adopt with the same dedupe id returns the first stream and
  claims no second slot or page set;
- chunk faults surface as ``KVWireError`` at unpack; through the router,
  ``kv_chunk_corrupt`` costs exactly one fresh prefill round and
  ``transport_prefill`` / ``crash_mid_transfer`` one retry of their
  leg, each with the tokens unchanged.
"""

import asyncio
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu import retry as jax_retry
from gofr_tpu_torch.metrics import Manager, register_engine_metrics
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu import faults, kv_wire
from gofr_tpu_torch.tpu import retry as pt_retry
from gofr_tpu_torch.tpu.cluster import (ROLE_DECODE, ROLE_PREFILL,
                                        ClusterRegistry, DisaggRouter,
                                        InProcTransport)
from gofr_tpu_torch.tpu.generate import GenerationEngine

MODULES = {"jax": jax_retry, "port": pt_retry}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.reset()


@pytest.fixture(scope="module")
def model():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    return tcfg, from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")


def _engine(model, **kw):
    tcfg, tparams = model
    return GenerationEngine(tcfg, tparams, **dict(
        dict(max_slots=2, max_len=32, prompt_buckets=(8,), paged_kv=True,
             kv_page=4), **kw), device="cpu")


def _attempts_trace(mod):
    out = []
    calls = []

    async def fail(attempt):
        calls.append(attempt)
        raise ConnectionError(f"attempt {attempt}")

    policy = mod.RetryPolicy(attempts=3, base_s=0.0)
    try:
        asyncio.run(policy.run(fail))
    except mod.RetryBudgetExceeded as exc:
        out.append((str(exc), type(exc.__cause__).__name__,
                    str(exc.__cause__)))
    out.append(list(calls))

    async def flaky(attempt):
        if attempt < 3:
            raise ConnectionError("transient")
        return "ok"
    out.append(asyncio.run(mod.RetryPolicy(attempts=3,
                                           base_s=0.0).run(flaky)))
    calls.clear()
    try:
        asyncio.run(policy.run(fail, retryable=lambda exc: not isinstance(
            exc, ConnectionError)))
    except ConnectionError as exc:
        out.append(str(exc))
    out.append(list(calls))
    retried = []
    try:
        asyncio.run(mod.RetryPolicy(attempts=2, base_s=0.0).run(
            fail, on_retry=lambda attempt, exc: retried.append(attempt)))
    except mod.RetryBudgetExceeded:
        out.append(list(retried))
    out.append(mod.RetryPolicy(attempts=0).attempts)
    return out


def test_retry_bounded_attempts_and_cause_as_jax():
    got = _attempts_trace(pt_retry)
    assert got == _attempts_trace(jax_retry)
    assert got[1] == [1, 2, 3] and got[2] == "ok" and got[4] == [1]


class _Config:
    def __init__(self, **values):
        self.values = values

    def get_float(self, key, default):
        return float(self.values.get(key, default))


def test_retry_backoff_jitter_deadline_and_knobs_as_jax():
    waits = {}
    for name, mod in MODULES.items():
        policy = mod.RetryPolicy(attempts=5, base_s=0.1, multiplier=2.0,
                                 jitter=0.5, rng=random.Random(11))
        waits[name] = [policy.backoff_s(a) for a in (1, 2, 3, 4, 2, 3)]
    assert waits["port"] == waits["jax"]
    assert waits["port"][0] == 0.0
    for attempt, wait in zip((2, 3, 4), waits["port"][1:4]):
        raw = 0.1 * 2.0 ** (attempt - 2)
        assert raw * 0.5 <= wait <= raw
    calls = []

    async def fail(attempt):
        calls.append(attempt)
        raise ConnectionError("down")

    tight = pt_retry.RetryPolicy(attempts=50, base_s=0.2, deadline_s=0.05)
    start = time.monotonic()
    with pytest.raises(pt_retry.RetryBudgetExceeded):
        asyncio.run(tight.run(fail))
    assert time.monotonic() - start < 2.0
    assert len(calls) < 50
    for values in ({}, {"DISAGG_RETRY_ATTEMPTS": 1},
                   {"DISAGG_RETRY_BASE_MS": 10, "DISAGG_RETRY_DEADLINE_MS":
                    250, "DISAGG_HEDGE_AFTER_MS": 40}):
        policies = [mod.new_retry_policy(_Config(**values))
                    for mod in MODULES.values()]
        fields = [(p.attempts, p.base_s, p.multiplier, p.jitter,
                   p.deadline_s, p.hedge_after_s) for p in policies]
        assert fields[0] == fields[1], values


def _hedge_trace(mod):
    async def slow():
        await asyncio.sleep(5.0)
        return "primary"

    async def fast():
        return "backup"

    async def quick():
        return "primary"

    async def boom():
        raise ConnectionError("primary down")

    async def boom_backup():
        raise ValueError("backup down")

    policy = mod.RetryPolicy(hedge_after_s=0.01)
    out = [asyncio.run(policy.hedged(slow, fast)),
           asyncio.run(policy.hedged(quick, fast)),
           asyncio.run(mod.RetryPolicy(hedge_after_s=None).hedged(quick,
                                                                  fast))]
    try:
        asyncio.run(policy.hedged(boom, boom_backup))
    except ConnectionError as exc:
        out.append(str(exc))
    return out


def test_hedged_backup_races_a_slow_primary_as_jax():
    got = _hedge_trace(pt_retry)
    assert got == _hedge_trace(jax_retry)
    assert got[0] == ("backup", True) and got[1] == ("primary", False)


def test_adopt_dedupe_returns_the_prior_stream_once(model):
    async def run():
        source = _engine(model)
        metrics = register_engine_metrics(Manager())
        engine = _engine(model, metrics=metrics)
        await engine.start()
        try:
            payload = await source.prefill_export([1, 2, 3, 4, 5])
            baseline = engine._pool.free_pages
            free_slots = len(engine._free)
            first = await engine.adopt_kv(payload, 4, dedupe="handoff-1")
            claimed = baseline - engine._pool.free_pages
            assert claimed == payload.n_pages == 2
            replay = await engine.adopt_kv(payload, 4, dedupe="handoff-1")
            assert replay is first
            assert baseline - engine._pool.free_pages == claimed
            assert len(engine._free) == free_slots - 1
            assert engine.stats()["resilience"]["adopt_dedup_hits"] == 1
            assert metrics.value("app_tpu_adopt_dedup_total",
                                 model="generate") == 1
            other = await engine.adopt_kv(payload, 4, dedupe="handoff-2")
            assert other is not first
            outs = [[t async for t in stream] for stream in (first, other)]
            assert outs[0] == outs[1] and len(outs[0]) == 4
        finally:
            await engine.stop()
        assert engine._pool.free_pages == baseline

    asyncio.run(run())


def test_chunk_faults_surface_as_kv_wire_errors(model):
    async def run():
        payload = await _engine(model).prefill_export([1, 2, 3, 4, 5])
        return kv_wire.pack(payload)
    blob = asyncio.run(run())
    faults.install(faults.FaultPlan("kv_chunk_truncate"))
    truncated = kv_wire.assemble(kv_wire.iter_chunks(blob, 64))
    assert len(truncated) < len(blob)
    with pytest.raises(kv_wire.KVWireError):
        kv_wire.unpack(truncated)
    faults.install(faults.FaultPlan("kv_chunk_corrupt"))
    corrupt = kv_wire.assemble(kv_wire.iter_chunks(blob, 64))
    assert len(corrupt) == len(blob) and corrupt != blob
    with pytest.raises(kv_wire.KVWireError):
        kv_wire.unpack(corrupt)
    faults.reset()
    assert kv_wire.assemble(kv_wire.iter_chunks(blob, 64)) == blob


async def _route(model, prompts, plan=None):
    prefill_eng = _engine(model, paged_kv=False)
    decode_eng = _engine(model)
    cluster = ClusterRegistry()
    cluster.register("p0", ROLE_PREFILL, InProcTransport(prefill_eng))
    cluster.register("d0", ROLE_DECODE, InProcTransport(decode_eng))
    metrics = register_engine_metrics(Manager())
    router = DisaggRouter(cluster, metrics=metrics,
                          retry_policy=pt_retry.RetryPolicy(base_s=0.0))
    await decode_eng.start()
    if plan is not None:
        faults.install(faults.FaultPlan(plan))
    try:
        outs = [await asyncio.wait_for(router.generate(p, 6), 60.0)
                for p in prompts]
    finally:
        faults.reset()
        await decode_eng.stop()
    return (outs, prefill_eng.stats()["kv_exports"],
            decode_eng.stats()["kv_adoptions"], router.stats()["retries"],
            metrics)


@pytest.mark.parametrize("plan,leg,exports", [
    ("kv_chunk_corrupt:@1", "wire", 3),
    ("transport_prefill:@1", "prefill", 3),
    ("crash_mid_transfer:@1", "adopt", 2)])
def test_router_faults_cost_one_round_and_keep_tokens(model, plan, leg,
                                                      exports):
    prompts = [[1, 2, 3, 4, 5], [7, 7, 7]]
    want = asyncio.run(_route(model, prompts))[0]
    outs, n_exports, adoptions, retries, metrics = asyncio.run(
        _route(model, prompts, plan))
    assert outs == want
    assert (n_exports, adoptions, retries) == (exports, 2, 1)
    assert metrics.value("app_tpu_disagg_retry_total", leg=leg) == 1
