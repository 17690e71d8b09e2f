"""The port engine's pipelined, compiled ticks on the CPU (the same tick
functions the card captures as graphs, run eagerly).

- Tokens publish in dispatch order at every depth: each stream yields
  the tokens of the same request served alone, with 4 ticks in flight.
- A speculative tick is charged g + 1 tokens and refunded at publish:
  with 4 ticks in flight no slot ever has more tokens in flight than its
  budget left, and every completion has exactly its budget.
- Tokens of a slot that finished (eos) or was cancelled while later
  ticks were in flight are dropped; the slot's next request is served
  from a clean state.
- A failed dispatch drains the in-flight fetches, fails the callers
  bound to slots, and clears the pool and the slot state in place: every
  pool leaf and state buffer keeps its ``data_ptr()``; the engine keeps
  serving.
- The static-shape pool write: a paged decode or verify step leaves every
  pool row but the scratch page bitwise unchanged apart from its live
  destinations.
- The construction predicate for the card (``cuda_refusals``) names each
  limit the kernels would hit; the CPU engine takes every one of those
  configurations.

Float32 ``tiny`` model, paged (``kv_page=4``); the reference tokens are
the port's own engine at depth 1, which tests/test_torch_engine.py holds
to the JAX engine.
"""

import asyncio
import dataclasses

import pytest
import torch

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.tpu.generate import (GenerationEngine, Sampling,
                                         cuda_refusals)
from gofr_tpu_torch.tpu.page_pool import PagePool

PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 11)), [9, 8, 7], [4, 4, 4, 4]]
BUDGET = 8
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 paged_kv=True, kv_page=4)


@pytest.fixture(scope="module")
def model():
    cfg = llama.config("tiny", dtype=torch.float32, use_flash=True)
    return cfg, llama.init(cfg, 0, device="cpu"), llama.init(cfg, 7,
                                                             device="cpu")


def _engine(model, spec=False, **kw):
    cfg, params, draft = model
    if spec:
        kw = dict(dict(draft_cfg=cfg, draft_params=draft, spec_gamma=4), **kw)
    return GenerationEngine(cfg, params, device="cpu", **{**ENGINE_KW, **kw})


def _run(engine, body):
    async def main():
        await engine.start()
        try:
            return await asyncio.wait_for(body(engine), 120.0)
        finally:
            await engine.stop()
    return asyncio.run(main())


async def _alone(engine):
    return [await engine.generate(p, BUDGET) for p in PROMPTS]


@pytest.fixture(scope="module")
def reference(model):
    return _run(_engine(model, max_inflight_ticks=1), _alone)


@pytest.mark.parametrize("spec", [False, True])
def test_streams_publish_in_dispatch_order(model, reference, spec):
    async def streams(engine):
        opened = [await engine.generate_stream(p, BUDGET) for p in PROMPTS]

        async def drain(stream):
            return [tok async for tok in stream]
        return list(await asyncio.gather(*[drain(s) for s in opened]))

    engine = _engine(model, spec=spec, max_inflight_ticks=4)
    assert _run(engine, streams) == reference
    assert engine.stats()["ticks_inflight_peak"] >= 2


def test_spec_refunds_never_overshoot_a_budget(model):
    engine = _engine(model, spec=True, max_inflight_ticks=4)
    budgets = [1, 2, 3, 5, 9, 13]
    publish = engine._publish
    seen = []

    def checked(entry, host):
        publish(entry, host)
        for slot in engine._slots:
            if slot.active:
                seen.append(slot.inflight)
                assert 0 <= slot.inflight <= slot.remaining

    engine._publish = checked

    async def body(engine):
        return await asyncio.gather(*[
            engine.generate(PROMPTS[i % 4], b) for i, b in enumerate(budgets)])

    outs = _run(engine, body)
    assert [len(out) for out in outs] == budgets
    assert max(seen) > 1 and engine.stats()["ticks_inflight_peak"] >= 2
    assert engine.stats()["speculative"]["spec_ticks"] > 0
    assert engine.stats()["kv_pool"]["used_pages"] == 0


@pytest.mark.parametrize("spec", [False, True])
def test_tokens_after_eos_or_cancel_in_flight_are_dropped(model, reference,
                                                          spec):
    async def body(engine):
        eos = reference[1][2]
        stopped = await engine.generate(PROMPTS[1], BUDGET, eos_id=eos)
        peak = engine.stats()["ticks_inflight_peak"]
        stream = await engine.generate_stream(PROMPTS[0], BUDGET)
        first = await stream.__anext__()
        stream.cancel()
        after = await engine.generate(PROMPTS[2], BUDGET)
        return stopped, peak, first, after

    engine = _engine(model, spec=spec, max_inflight_ticks=4)
    stopped, peak, first, after = _run(engine, body)
    assert stopped == reference[1][:reference[1].index(reference[1][2]) + 1]
    assert peak >= 2
    assert first == reference[0][0]
    assert after == reference[2]
    stats = engine.stats()
    assert stats["active_slots"] == 0 and stats["kv_pool"]["used_pages"] == 0


def _buffers(engine):
    tensors = dict(engine._pool.leaves)
    tensors.update(cache_len=engine.cache_len, last_token=engine.last_token,
                   temps=engine.temps, top_ks=engine.top_ks,
                   top_ps=engine.top_ps, sample_keys=engine.sample_keys,
                   active=engine.active, table=engine.table)
    if engine.spec:
        tensors.update({f"draft.{k}": v
                        for k, v in engine._draft_cache.items()})
    return tensors


@pytest.mark.parametrize("spec", [False, True])
def test_failure_drains_fetches_and_resets_in_place(model, reference, spec):
    engine = _engine(model, spec=spec, max_inflight_ticks=2)
    ptrs = {name: t.data_ptr() for name, t in _buffers(engine).items()}
    run_tick = engine._run_tick
    calls, drained = [], []

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            drained.extend(engine._publishq)
            raise RuntimeError("injected tick failure")
        return run_tick(*args)

    engine._run_tick = failing

    async def body(engine):
        outs = await asyncio.gather(
            *[engine.generate(p, BUDGET, sampling=Sampling(0.9, seed=3))
              for p in PROMPTS[:2]], return_exceptions=True)
        engine._run_tick = run_tick
        return outs, await engine.generate(PROMPTS[2], BUDGET)

    outs, after = _run(engine, body)
    assert all(isinstance(o, RuntimeError) for o in outs)
    assert drained and all(entry.task.done() for entry in drained)
    assert not engine._publishq and engine.stats()["ticks_inflight"] == 0
    assert {n: t.data_ptr() for n, t in _buffers(engine).items()} == ptrs
    assert after == reference[2]
    assert engine.stats()["kv_pool"]["used_pages"] == 0


def _random_pool(cfg, num_pages, seed):
    pool = PagePool(cfg, page=4, num_pages=num_pages, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for leaf in pool.leaves.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    return pool


@pytest.mark.parametrize("g_len", [1, 3])
def test_static_shape_write_touches_only_live_destinations(model, g_len):
    cfg, params, _ = model
    pool = _random_pool(cfg, 12, g_len)
    before = {name: leaf.clone() for name, leaf in pool.leaves.items()}
    s = pool.sentinel
    # slot 0 live; slot 1 inactive; slot 2's next page is the sentinel;
    # slot 3's new tokens run past its table (2 columns)
    table = torch.tensor([[0, 1, s, s], [2, 3, s, s], [4, s, s, s],
                          [5, 6, s, s]], dtype=torch.int32)
    lens = torch.tensor([5, 2, 4, 7], dtype=torch.int32)
    active = torch.tensor([True, False, True, True])
    tokens = torch.tensor([[3, 1, 4], [1, 5, 9], [2, 6, 5], [3, 5, 8]])
    if g_len == 1:
        llama.decode_step_paged(params, cfg, tokens[:, 0], pool.leaves,
                                table[:, :2], lens, active)
    else:
        llama.verify_step_paged(params, cfg, tokens, pool.leaves,
                                table[:, :2], lens, active)
    live = set()
    for row in range(4):
        for g in range(g_len):
            pos = int(lens[row]) + g
            col = pos // 4
            if active[row] and col < 2 and int(table[row, col]) < s:
                live.add((int(table[row, col]), pos % 4))
    assert len(live) == (2 if g_len == 1 else 4)
    for name, leaf in pool.leaves.items():
        changed = (leaf != before[name]).flatten(3 if leaf.dim() == 5
                                                 else 2).any(-1).any(0)
        moved = {(int(p), int(o)) for p, o in changed[:s].nonzero()}
        assert moved == live, name


def test_cuda_refusal_predicate_names_each_limit(model):
    cfg = llama.config("llama3-8b")
    assert cuda_refusals(cfg, 2048, 32, cfg, 4, paged_kv=True) == []
    assert cuda_refusals(cfg, 8192, 32, paged_kv=True) == []
    cases = {
        "MAX_VERIFY_TOKENS": (cfg, dict(spec_gamma=ragged_mod
                                        .MAX_VERIFY_TOKENS)),
        "head_dim 96": (dataclasses.replace(cfg, dim=3072), {}),
        "GQA group 32/3": (dataclasses.replace(cfg, n_kv_heads=3), {}),
        "dtype torch.float32": (dataclasses.replace(cfg,
                                                    dtype=torch.float32),
                                {}),
        "MAX_DYN_SMEM": (dataclasses.replace(cfg, n_kv_heads=4),
                         dict(max_len=16384)),
    }
    for limit, (c, kw) in cases.items():
        kw = {**dict(max_len=2048, kv_page=32, draft_cfg=c, spec_gamma=4,
                     paged_kv=True), **kw}
        refused = cuda_refusals(c, **kw)
        assert any(limit in line for line in refused), (limit, refused)
    # the CPU runs the plain versions, which take every one of them
    tiny, params, _ = model
    for over in (dict(dim=96, n_heads=4, n_kv_heads=2), dict(n_kv_heads=1),
                 dict(dtype=torch.float32)):
        c = dataclasses.replace(tiny, **over)
        GenerationEngine(c, llama.init(c, 0, device="cpu"), device="cpu",
                         draft_cfg=c, draft_params=llama.init(c, 1,
                                                              device="cpu"),
                         spec_gamma=9, **ENGINE_KW)
