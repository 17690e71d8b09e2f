"""Port parity for the paged engine's pool-wedge breaker (JAX
``_shed_newest``) on the CPU (``tiny``, float32).

Two 8-token prompts with 20 new tokens each need 7 pages of 4 tokens
apiece, and the pool holds 8: both slots run short and nothing is
reclaimable. With no tick in flight the engine fails the NEWEST request
with JAX's message, its pages go back, and the first request finishes.
Plain and speculative, each against the JAX engine in the same setup
(whose answer includes its compiles); the port answers within 10 s, and
the pool's free pages come back to their starting count.
"""

import asyncio
import time

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
from gofr_tpu_torch.tpu.generate import GenerationEngine

PROMPTS = [list(range(1, 9)), list(range(11, 19))]
BUDGET = 20
WEDGE_KW = dict(max_slots=2, max_len=64, prompt_buckets=(8, 16),
                paged_kv=True, kv_page=4, kv_pages=8, kv_page_reserve=0,
                max_inflight_ticks=1)
MESSAGE = ("kv page pool wedged: no slot can grow and nothing is "
           "reclaimable; shedding the newest request")


async def _serve(engine):
    free = engine._pool.free_pages
    await engine.start()
    try:
        first = asyncio.ensure_future(engine.generate(PROMPTS[0], BUDGET))
        await asyncio.sleep(0)
        second = asyncio.ensure_future(engine.generate(PROMPTS[1], BUDGET))
        t0 = time.monotonic()
        done = await asyncio.wait_for(
            asyncio.gather(first, second, return_exceptions=True), 120.0)
        return done, time.monotonic() - t0, free, engine._pool.free_pages
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    return jcfg, jax.tree.map(np.asarray,
                              jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _engines(weights, spec):
    jcfg, jparams = weights
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    tparams = from_jax_llama(jparams, "cpu")
    jkw, tkw = dict(WEDGE_KW), dict(WEDGE_KW)
    if spec:
        jkw.update(draft_cfg=jcfg, draft_params=jparams, spec_gamma=4)
        tkw.update(draft_cfg=tcfg, draft_params=tparams, spec_gamma=4)
    container = new_mock_container()
    jax_engine = JaxEngine(jcfg, jparams, logger=container.logger,
                           metrics=container.metrics, **jkw)
    return jax_engine, GenerationEngine(tcfg, tparams, device="cpu", **tkw)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_wedged_pool_sheds_the_newest_request_as_jax(weights, spec):
    jax_engine, port = _engines(weights, spec)
    outcomes = {}
    for name, engine in (("jax", jax_engine), ("port", port)):
        (first, second), seconds, free_before, free_after = \
            asyncio.run(_serve(engine))
        assert name == "jax" or seconds < 10.0, seconds
        assert isinstance(second, RuntimeError), (name, second)
        assert str(second) == MESSAGE
        assert free_after == free_before, name
        outcomes[name] = first
    assert len(outcomes["port"]) == BUDGET
    assert outcomes["port"] == outcomes["jax"]
    stats = port.stats()
    assert stats["kv_pool"]["page_stalls"] > 0
    assert stats["kv_pool"]["deferred_requests"] == 0
    assert port.stats()["free_slots"] == WEDGE_KW["max_slots"]
