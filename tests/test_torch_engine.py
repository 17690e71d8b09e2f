"""Port parity for the generation engine: greedy token identity between
the port's engine on the CPU and the JAX engine, both paged
(``kv_page=4``), the JAX side with the ragged Pallas kernel on (interpret
mode) and both with ``use_flash=True`` — the setup of
tests/test_ragged_attention.py's engine identity test, at float32.

The JAX engine runs once per module so its compiles are paid once; the
pipelined cases run the JAX engine once per (``max_inflight_ticks``,
``steps_per_tick``) at the same depth, the requests served concurrently.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu.generate import GenerationEngine, Sampling

PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 11)), [9, 8, 7]]
BUDGET = 6
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 paged_kv=True, kv_page=4)


async def _serve(engine, prompts, concurrent=False, **kw):
    await engine.start()
    try:
        if concurrent:
            return list(await asyncio.wait_for(asyncio.gather(
                *[engine.generate(p, max_new_tokens=BUDGET, **kw)
                  for p in prompts]), 60.0))
        return [await asyncio.wait_for(
            engine.generate(p, max_new_tokens=BUDGET, **kw), 60.0)
            for p in prompts]
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    container = new_mock_container()
    jax_engine = JaxEngine(jcfg, jparams, logger=container.logger,
                           metrics=container.metrics,
                           ragged_attn="on", **ENGINE_KW)
    reference = asyncio.run(_serve(jax_engine, PROMPTS))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    return tcfg, tparams, reference


@pytest.fixture(scope="module")
def jax_at_depth():
    """The JAX engine's concurrent greedy output at a pipeline depth and
    steps per tick, each computed once."""
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    cache = {}

    def run(inflight, steps_per_tick):
        if (inflight, steps_per_tick) not in cache:
            container = new_mock_container()
            engine = JaxEngine(jcfg, jparams, logger=container.logger,
                               metrics=container.metrics,
                               ragged_attn="on", max_inflight_ticks=inflight,
                               steps_per_tick=steps_per_tick, **ENGINE_KW)
            cache[inflight, steps_per_tick] = asyncio.run(
                _serve(engine, PROMPTS, concurrent=True))
        return cache[inflight, steps_per_tick]
    return run


def _engine(setup, **kw):
    tcfg, tparams, _ = setup
    return GenerationEngine(tcfg, tparams, device="cpu",
                            **{**ENGINE_KW, **kw})


@pytest.mark.parametrize("steps_per_tick", [1, 4])
def test_greedy_identity_with_jax_engine(setup, steps_per_tick):
    engine = _engine(setup, steps_per_tick=steps_per_tick)
    assert asyncio.run(_serve(engine, PROMPTS)) == setup[2]
    stats = engine.stats()
    assert stats["prefill_dispatches"] == len(PROMPTS)
    assert stats["kv_pool"]["used_pages"] == 0     # every page came back


@pytest.mark.parametrize("steps_per_tick", [1, 4])
@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_greedy_identity_with_jax_engine_at_depth(setup, jax_at_depth,
                                                  inflight, steps_per_tick):
    engine = _engine(setup, steps_per_tick=steps_per_tick,
                     max_inflight_ticks=inflight)
    out = asyncio.run(_serve(engine, PROMPTS, concurrent=True))
    assert out == jax_at_depth(inflight, steps_per_tick) == setup[2]
    stats = engine.stats()
    assert stats["max_inflight_ticks"] == inflight
    assert min(inflight, 2) <= stats["ticks_inflight_peak"] <= inflight
    assert stats["ticks_inflight"] == 0
    assert stats["kv_pool"]["used_pages"] == 0


def test_concurrent_requests_batch_and_match(setup):
    engine = _engine(setup, steps_per_tick=2)
    assert asyncio.run(_serve(engine, PROMPTS, concurrent=True)) == setup[2]
    # all three admitted in one pass: buckets 8 and 16 → two prefills
    assert engine.prefill_dispatches == 2


def test_stream_matches_generate_and_seeded_sampling_repeats(setup):
    async def run():
        engine = _engine(setup)
        await engine.start()
        try:
            stream = await engine.generate_stream(PROMPTS[0], BUDGET)
            streamed = [tok async for tok in stream]
            sampling = dict(temperature=0.9, top_k=20, seed=7)
            a = await engine.generate(PROMPTS[1], BUDGET,
                                      sampling=Sampling(**sampling))
            b = await engine.generate(PROMPTS[1], BUDGET,
                                      sampling=Sampling(**sampling))
            return streamed, a, b
        finally:
            await engine.stop()

    streamed, a, b = asyncio.run(run())
    assert streamed == setup[2][0]
    assert a == b and len(a) == BUDGET
    assert all(0 <= t < 256 for t in a)


def test_eos_and_cancel_free_the_slot(setup):
    async def run():
        engine = _engine(setup)
        await engine.start()
        try:
            eos = setup[2][0][2]
            out = await engine.generate(PROMPTS[0], BUDGET, eos_id=eos)
            stream = await engine.generate_stream(PROMPTS[1], BUDGET)
            first = await stream.__anext__()
            stream.cancel()
            await asyncio.sleep(0.05)
            return out, first, engine.stats()
        finally:
            await engine.stop()

    out, first, stats = asyncio.run(run())
    assert out == setup[2][0][:3]
    assert first == setup[2][1][0]
    assert stats["active_slots"] == 0
    assert stats["kv_pool"]["used_pages"] == 0


def test_validation_errors(setup):
    engine = _engine(setup)

    async def run(prompt, budget):
        return await engine.generate(prompt, budget)

    with pytest.raises(ValueError, match="bucket"):
        asyncio.run(run(list(range(17)), 1))
    with pytest.raises(ValueError, match="cache length"):
        asyncio.run(run([1, 2], 63))


def test_page_pool_alloc_release_and_leaves(setup):
    from gofr_tpu_torch.tpu.page_pool import PagePool

    tcfg = setup[0]
    pool = PagePool(tcfg, page=4, num_pages=3, device="cpu")
    # three usable pages and the scratch page at the sentinel id
    assert pool.leaves["k"].shape == (tcfg.n_layers, 4, 4, tcfg.n_kv_heads,
                                      tcfg.head_dim)
    assert not pool.leaves["v"].any() and pool.sentinel == 3
    assert pool.stats()["num_pages"] == 3
    assert pool.pool_bytes == 3 * pool.page_bytes
    ids = pool.alloc(2)
    assert len(ids) == 2 and pool.free_pages == 1
    assert pool.alloc(2) is None and pool.stalls == 1    # all or nothing
    assert pool.alloc(1)[0] != pool.sentinel             # never the scratch
    pool.release(ids)
    pool.release(ids)                                    # already free: no-op
    assert pool.free_pages == 2 and pool.used_pages == 1
    # reset clears the same tensors in place
    ptrs = {name: leaf.data_ptr() for name, leaf in pool.leaves.items()}
    pool.leaves["k"].fill_(3.0)
    pool.reset()
    assert {name: leaf.data_ptr() for name, leaf in pool.leaves.items()} \
        == ptrs
    assert not pool.leaves["k"].any() and pool.free_pages == 3
