"""The engine's compiled prefill on the CPU, against the JAX engine, and the
``kv_int8`` draft.

One prefill executable a rung ``(nb, bucket, prefix rung, biased, draft
bucket)``: a host part packs the group into the rung's static buffers,
and a body that reads only those and the engine's state runs the prompt
forward and the insert (on the card a CUDA graph; here eagerly).

- A burst with every kind of group, on both layouts, with a float32 and a
  ``kv_int8`` target, each with a ``kv_int8`` draft of the target's own
  weights (γ 1, one tick in flight, so every dispatch decision is the
  published state's and the counts below do not depend on timing): a
  full prefill
  that publishes (dense) or registers (paged) its head, then at once a
  suffix group of two prompts over that head (the draft prefilling the
  whole prompts at its own bucket), a full group and a constrained
  request (a biased group). Greedy tokens, the speculative counts
  (proposed, accepted, spec ticks: what the int8 draft decides, most of
  its proposals accepted) and the prefix store's counts equal the JAX
  engine's; the port's rungs are one of each kind.
- Padding rows write nothing: with 1..max_slots rows of a group claimed
  (the rest padding), every slot no row claims keeps its cache rows
  (dense) or the pages no row was given (paged), its draft rows, its
  cache_len, last token, temperature, top-k, top-p and key bit for bit,
  and the store's pool keeps every page it was not asked to publish.
- ``warmup(prompt_counts=(1, max_slots), sampling=True)``, the example
  app's call, is accepted and warms the full prefill of every bucket at
  both counts; after it, a burst with a sampled request gives the JAX
  engine's tokens after the same warmup (sampled tokens equal, as
  tests/test_torch_prng.py holds them: no Gumbel scores of this burst tie
  within 1e-5).
- ``cuda_refusals`` holds an int8 draft to the ragged kernel's limits.

The model is the ``tiny`` preset at float32 (the repo's parity bar).
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.generate import Sampling as JaxSampling
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu.generate import (GenerationEngine, Sampling, _pack,
                                         _prefill_key, cuda_refusals)

PAGE = 4
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 prefix_page=PAGE)
SPEC_KW = dict(spec_gamma=1, max_inflight_ticks=1)
LAYOUTS = {"dense": {}, "paged": dict(paged_kv=True, kv_page=PAGE)}
TARGETS = {"f32": False, "kv_int8": True}
HEAD = [11, 12, 13, 14, 15, 16, 17, 18]          # two pages of 4
REGEX_RF = {"type": "regex", "pattern": "(yes|no)!"}
# a full prefill of HEAD + 3, then at once: two prompts over HEAD (a
# suffix group at rung 2), a short prompt (a full group) and a
# constrained request (a biased group)
FIRST = (HEAD + [21, 22, 23], 6, None)
# one bucket keeps the JAX engines' compiles few
BURST_KW = dict(ENGINE_KW, prompt_buckets=(16,))
WAVE = [(HEAD + [31, 32], 6, None), (HEAD + [41, 42, 43, 44, 45], 6, None),
        ([5, 6, 7, 8, 9], 6, None), ([1, 2, 3], 8, REGEX_RF)]


def _cfgs(int8=False, **over):
    return (jax_llama.config("tiny", dtype=jnp.float32, use_flash=True,
                             kv_int8=int8, **over),
            pt_llama.config("tiny", dtype=torch.float32, use_flash=True,
                            kv_int8=int8, **over))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


async def _burst(engine):
    await engine.start()
    try:
        prompt, n, rf = FIRST
        outs = [await asyncio.wait_for(
            engine.generate(prompt, n, response_format=rf), 60.0)]
        outs += await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, n, response_format=rf)
            for p, n, rf in WAVE]), 60.0)
        return outs
    finally:
        await engine.stop()


def _counts(stats):
    spec, store = stats["speculative"], stats["prefix_cache"]
    return dict(spec={k: spec[k] for k in ("spec_ticks", "proposed",
                                           "accepted")},
                store={k: store[k] for k in ("lookups", "tokens_saved",
                                             "inserts", "publishes")},
                bucket_tokens=stats["prefill_bucket_tokens"],
                constrained=stats["constrained"]["requests"])


@pytest.fixture(scope="module")
def jax_bursts(weights):
    """The JAX engine's burst on each (layout, target), a kv_int8 draft
    in every one; computed once."""
    out = {}
    for layout, kw in LAYOUTS.items():
        for name, int8 in TARGETS.items():
            jcfg, _ = _cfgs(int8)
            jdcfg, _ = _cfgs(True)
            container = new_mock_container()
            engine = JaxEngine(jcfg, weights, logger=container.logger,
                               metrics=container.metrics, prefix_cache=True,
                               draft_cfg=jdcfg, draft_params=weights,
                               **SPEC_KW, **BURST_KW, **kw)
            out[layout, name] = (asyncio.run(_burst(engine)),
                                 _counts(engine.stats()))
    return out


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_group_kind_with_an_int8_draft_matches_jax(weights, jax_bursts,
                                                         layout, target):
    params = from_jax_llama(weights, "cpu")
    _, tcfg = _cfgs(TARGETS[target])
    _, dcfg = _cfgs(True)
    engine = GenerationEngine(tcfg, params, device="cpu", prefix_cache=True,
                              draft_cfg=dcfg, draft_params=params,
                              **SPEC_KW, **BURST_KW, **LAYOUTS[layout])
    # the int8 draft decodes through the ragged route over its identity
    # tables (one a window rung, made at construction) and keeps its scale
    # planes
    assert not engine.draft_cfg.use_flash_decode
    assert engine._draft_cache["k"].dtype == torch.int8
    assert set(engine._draft_cache) == {"k", "v", "ks", "vs"}
    assert set(engine._draft_tables) == set(engine._window_ladder)
    outs = asyncio.run(_burst(engine))
    want_outs, want_counts = jax_bursts[layout, target]
    assert outs == want_outs
    counts = _counts(engine.stats())
    assert counts == want_counts
    assert counts["spec"]["accepted"] >= 0.5 * counts["spec"]["proposed"] > 0
    assert counts["store"]["tokens_saved"] == 2 * len(HEAD)
    # one rung of each kind: a full prefill, the suffix group's (rung 2,
    # its draft bucket 16), the biased group's
    keys = set(engine._prefills)
    assert (2, 16, 2, False, 16) in keys
    assert any(key[3] for key in keys)
    assert any(not key[2] and not key[3] for key in keys)
    assert engine.stats()["graphs"]["prefill"]["captured"] == 0


def _state(engine):
    tensors = {"cache_len": engine.cache_len, "last_token": engine.last_token,
               "temps": engine.temps, "top_ks": engine.top_ks,
               "top_ps": engine.top_ps, "keys": engine.sample_keys}
    if engine.paged:
        tensors.update({f"pool.{k}": v
                        for k, v in engine._pool.leaves.items()})
    else:
        tensors.update({f"cache.{k}": v for k, v in engine.cache.items()})
        tensors.update({f"store.{k}": v
                        for k, v in engine._prefix._pool.leaves.items()})
    tensors.update({f"draft.{k}": v for k, v in engine._draft_cache.items()})
    return tensors


def _randomise(engine, seed):
    gen = torch.Generator().manual_seed(seed)
    for name, tensor in _state(engine).items():
        if tensor.dtype == torch.int8:
            tensor.copy_(torch.randint(-127, 128, tensor.shape,
                                       generator=gen, dtype=torch.int8))
        elif tensor.dtype.is_floating_point:
            tensor.copy_(torch.rand(tensor.shape, generator=gen) + 0.5)
        else:
            # out of every value a prefill writes
            tensor.copy_(torch.randint(1000, 2000, tensor.shape,
                                       generator=gen))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_padding_rows_write_nothing(weights, layout):
    params = from_jax_llama(weights, "cpu")
    _, tcfg = _cfgs(True)
    _, dcfg = _cfgs(True, n_layers=1)
    engine = GenerationEngine(tcfg, params, device="cpu", prefix_cache=True,
                              draft_cfg=dcfg, draft_params=params,
                              **ENGINE_KW, **LAYOUTS[layout])
    rng = np.random.default_rng(5)
    nb, bucket, n_slots = 4, 8, engine.max_slots
    for n in range(1, n_slots + 1):
        _randomise(engine, n)
        before = {k: v.clone() for k, v in _state(engine).items()}
        slots = rng.permutation(n_slots)[:n]
        arrays = engine._group_arrays(nb, bucket, 0)
        floats = engine._group_floats(nb, False).reshape(2, nb)
        pages = []
        for row, slot in enumerate(slots):
            length = int(rng.integers(2, bucket + 1))
            arrays["tokens"][row, :length] = rng.integers(0, 256, length)
            arrays["lengths"][row] = length
            arrays["row_of_slot"][slot] = row
            arrays["top_ks"][row] = 7 + row
            arrays["seeds"][row] = 100 + row
            floats[:, row] = (0.5, 0.9)
            if engine.paged:
                ids = engine._pool.alloc(bucket // PAGE)
                arrays["page_ids"][row * 2:row * 2 + 2] = ids
                pages += ids
        if "publish_ids" in arrays:
            # a page to publish for the first row; the rest sentinel
            arrays["publish_ids"][0] = 1
        ints, layout_ = _pack(arrays)
        first = engine._prefill_insert(nb, bucket, n, 0, ints, layout_,
                                       floats.ravel())()
        after = _state(engine)
        free = [s for s in range(n_slots) if s not in slots]
        for name, tensor in after.items():
            old = before[name]
            if name.startswith("pool."):
                # every page no row was given is untouched (the scratch
                # page takes the padding rows' writes)
                kept = [p for p in range(engine._pool.num_pages)
                        if p not in pages]
                assert torch.equal(tensor[:, kept], old[:, kept]), name
            elif name.startswith("store."):
                kept = [p for p in range(engine._prefix.num_pages)
                        if p != 1]
                assert torch.equal(tensor[:, kept], old[:, kept]), name
                assert not torch.equal(tensor[:, 1], old[:, 1]), name
            elif name.startswith(("cache.", "draft.")):
                assert torch.equal(tensor[:, free], old[:, free]), name
                assert not torch.equal(tensor[:, slots], old[:, slots])
            else:
                assert torch.equal(tensor[free], old[free]), name
                assert not torch.equal(tensor[slots], old[slots]), name
        np.testing.assert_array_equal(
            engine.last_token[slots].numpy(), first[:n])
        np.testing.assert_array_equal(engine.cache_len[slots].numpy(),
                                      arrays["lengths"][:n])
        if engine.paged:
            engine._pool.release(pages)


async def _warm_burst(engine, sampling):
    await engine.warmup(prompt_counts=(1, engine.max_slots), sampling=True)
    await engine.start()
    try:
        return await asyncio.wait_for(asyncio.gather(*[
            engine.generate(p, n, sampling=s)
            for (p, n, _), s in zip(WAVE, sampling)]), 60.0)
    finally:
        await engine.stop()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_warmup_of_the_example_app_matches_jax(weights, layout):
    params = weights
    jcfg, tcfg = _cfgs()
    samplings = [(0.0, 0, 1.0, 0), (0.8, 20, 0.95, 3), (0.0, 0, 1.0, 0),
                 (1.1, 0, 0.9, 5)]
    container = new_mock_container()
    jax_engine = JaxEngine(jcfg, params, logger=container.logger,
                           metrics=container.metrics, **BURST_KW,
                           **LAYOUTS[layout])
    want = asyncio.run(_warm_burst(jax_engine,
                                   [JaxSampling(*s) for s in samplings]))
    engine = GenerationEngine(tcfg, from_jax_llama(params, "cpu"),
                              device="cpu", **BURST_KW, **LAYOUTS[layout])
    got = asyncio.run(_warm_burst(engine, [Sampling(*s) for s in samplings]))
    assert got == want
    # the full prefill of the bucket at counts 1 and max_slots
    assert {(1, 16, 0, False, 0), (4, 16, 0, False, 0)} \
        <= set(engine._prefills)
    for bad in ((0,), (5,), ()):
        with pytest.raises(ValueError, match="prompt_counts"):
            asyncio.run(engine.warmup(prompt_counts=bad))


def test_prefill_key_names_the_draft_bucket(weights):
    _, tcfg = _cfgs()
    engine = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                              device="cpu", prefix_cache=True,
                              draft_cfg=dataclasses.replace(tcfg, n_layers=1),
                              draft_params=from_jax_llama(weights, "cpu"),
                              **ENGINE_KW)
    _, layout = _pack(engine._group_arrays(2, 8, 1, 16))
    assert _prefill_key(2, 8, 1, False, layout) == (2, 8, 1, False, 16)
    _, layout = _pack(engine._group_arrays(4, 16, 0))
    assert dict(layout)["publish_ids"] == (4 * 4,)
    assert _prefill_key(4, 16, 0, True, layout) == (4, 16, 0, True, 0)


def test_cuda_refusals_hold_an_int8_draft_to_the_ragged_kernel():
    cfg = pt_llama.config("llama3-8b")
    bf16_draft = dataclasses.replace(cfg, n_layers=4)
    int8_draft = dataclasses.replace(bf16_draft, kv_int8=True)
    for paged in (False, True):
        assert cuda_refusals(cfg, 2048, 32, int8_draft, 4,
                             paged_kv=paged) == []
    # a head_dim neither kernel takes
    odd = dataclasses.replace(int8_draft, dim=3072, n_heads=32)
    assert any("draft head_dim 96" in line
               for line in cuda_refusals(cfg, 2048, 32, odd, 4))
    # the draft's identity tables: max_len 1000 has no view page the
    # kernel is held at, on the paged engine too (its draft cache is
    # dense)
    assert any("dense view page" in line
               for line in cuda_refusals(cfg, 1000, 8, int8_draft, 4,
                                         paged_kv=True))
    assert not any("dense view page" in line
                   for line in cuda_refusals(cfg, 1000, 8, bf16_draft, 4,
                                             paged_kv=True))
    # the draft's widest identity table at one query a slot: over a 64K
    # cache a group-4 target fits a block's shared memory, a group-8
    # int8 draft does not (a bf16 one decodes through flash decode)
    wide = dataclasses.replace(int8_draft, n_kv_heads=4)
    refused = cuda_refusals(cfg, 1 << 16, 32, wide, 0, paged_kv=True)
    assert len(refused) == 1 and "shared memory" in refused[0]
    assert cuda_refusals(cfg, 1 << 16, 32,
                         dataclasses.replace(wide, kv_int8=False), 0,
                         paged_kv=True) == []
