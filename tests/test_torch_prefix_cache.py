"""Port parity for prefix KV reuse: ``tpu/prefix_cache.py`` and the
suffix-only prefill (``llama.prefill(prefix=, prefix_len=)``) on both KV
layouts of the engine.

- The store's cases of the JAX file (``tests/test_prefix_cache.py``:
  roundtrip, LRU and refcount pinning, budget sizing, reset) run on both
  packages' stores; a seeded sequence of inserts, lookups, pins and
  evictions gives both the same page ids, stats and digest, and
  ``chain_hashes`` / ``digest`` are bit-equal to JAX's.
- ``llama.prefill(prefix=)``: logits and the suffix cache against JAX's
  for the same prefix K/V (float32 ``atol=1e-4``; bf16 each row within
  relative L2 2e-2, as ``test_torch_dense``; int8 within one
  quantisation step, scales ``rtol=1e-5``), and at float32 against the
  port's own full prefill of the whole prompt.
- The engine with ``prefix_cache=True``, dense and paged, plain, int8
  and speculative, on ``tiny`` at float32 (the port's parity bar: at
  bf16 the two packages' engines part on one request of ten with the
  store off too, their bf16 roundings differing): the JAX engine's
  greedy tokens and the same store stats (lookups, tokens saved,
  inserts, pages) for the same request sequence (full hits, partial
  hits, a page-boundary prompt, then two waves of concurrent admissions
  sharing one prefix).
- At bf16, cache on equals cache off, dense and paged; the JAX file's
  engine cases (fewer prompt tokens prefilled, concurrent admissions
  sharing one prefix, eviction under a tight budget keeping outputs
  exact, a device-state reset invalidating the store).
- The in-place publish: with the device thread held, a suffix prefill
  that reads two cached pages is queued behind in-flight ticks, then a
  later admission evicts those pages and publishes another prompt's K/V
  into the same page ids; released, every request's tokens are the
  cache-off engine's.

Each JAX engine runs once per module.
"""

import asyncio
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.prefix_cache import PrefixStore as JaxStore
from gofr_tpu.tpu.prefix_cache import chain_hashes as jax_chain_hashes
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.prefix_cache import PrefixStore, chain_hashes

ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 prefix_page=4)
BF16_ROW_TOL = 2e-2


def _cfgs(dtype="f32", **over):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jax_llama.config("tiny", dtype=jdt, **over),
            pt_llama.config("tiny", dtype=tdt, **over))


def _store(impl, **kw):
    jcfg, tcfg = _cfgs()
    if impl == "jax":
        return JaxStore(jcfg, **kw)
    return PrefixStore(tcfg, device="cpu", **kw)


# -- the store (host index; tiny pools) ---------------------------------------

@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_store_lookup_insert_roundtrip(impl):
    store = _store(impl, page=4, max_pages=4, num_pages=8)
    prompt = list(range(1, 18))                   # 17 tokens -> 4 full pages
    assert store.lookup(prompt) == []
    assert store.max_lookup_pages(len(prompt)) == 4
    # a prompt of exactly N pages may only reuse N-1 (suffix keeps >= 1)
    assert store.max_lookup_pages(16) == 3
    pages = store.insert(prompt, 4)
    assert [is_new for _, is_new in pages] == [True] * 4
    chain = store.lookup(prompt)
    assert [n.page_id for n in chain] == [p for p, _ in pages]
    again = store.insert(prompt, 4)               # dedup: nothing new
    assert again == [(p, False) for p, _ in pages]
    other = prompt[:4] + [99] * 13                # diverges at page 2
    assert len(store.lookup(other)) == 1


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_store_eviction_lru_and_refcount_pinning(impl):
    store = _store(impl, page=4, max_pages=2, num_pages=2)
    a, b = [1] * 9, [2] * 9
    store.insert(a, 2)                            # fills both pages
    assert store.used_pages == 2
    chain_a = store.lookup(a)
    assert len(chain_a) == 2
    store.acquire(chain_a)                        # pinned: no eviction
    assert store.insert(b, 2) == []
    assert store.evictions == 0
    assert len(store.lookup(a)) == 2
    store.release(chain_a)                        # leaf-only LRU
    store.lookup(b)
    pages_b = store.insert(b, 1)
    assert len(pages_b) == 1 and pages_b[0][1] is True
    assert store.evictions == 1
    assert len(store.lookup(a)) == 1              # interior page survived
    assert len(store.lookup(b)) == 1


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_store_budget_sizes_pool(impl):
    jcfg, tcfg = _cfgs()
    page_bytes = (JaxStore if impl == "jax" else PrefixStore)._page_bytes(
        jcfg if impl == "jax" else tcfg, 4)
    tight = _store(impl, page=4, max_pages=2, budget_bytes=3 * page_bytes)
    assert tight.num_pages == 3
    assert tight.stats()["pool_bytes"] == 3 * tight.page_bytes
    assert page_bytes == JaxStore._page_bytes(jcfg, 4)


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_store_reset_clears_index_keeps_counters(impl):
    store = _store(impl, page=4, max_pages=2, num_pages=4)
    store.insert([1] * 9, 2)
    inserts = store.inserts
    store.reset()
    assert store.used_pages == 0
    assert store.lookup([1] * 9) == []
    assert store.inserts == inserts               # history survives


def test_store_sequence_matches_jax():
    """A seeded sequence of inserts, lookups (with their classification),
    pins, releases and evictions: the same page ids, nodes, stats and
    digest in both packages."""
    rng = np.random.default_rng(5)
    stores = [_store(impl, page=4, max_pages=3, num_pages=6)
              for impl in ("jax", "torch")]
    heads = [rng.integers(0, 50, 13).tolist() for _ in range(4)]
    pinned = [[], []]
    for step in range(60):
        head = heads[rng.integers(len(heads))]
        prompt = head[:4 * int(rng.integers(1, 4))] \
            + rng.integers(50, 60, int(rng.integers(1, 5))).tolist()
        op = rng.integers(4)
        out = []
        for i, store in enumerate(stores):
            if op == 0:
                out.append(store.insert(prompt, len(prompt) // 4))
            elif op == 1:
                chain = store.lookup(prompt)
                out.append((store.classify(
                    len(chain), store.max_lookup_pages(len(prompt))),
                    [n.page_id for n in chain]))
                store.acquire(chain)
                pinned[i].append(chain)
            elif op == 2:
                if pinned[i]:
                    store.release(pinned[i].pop(0))
                out.append(len(pinned[i]))
            else:
                out.append(store.evict_one())
        assert out[0] == out[1], step
    stats = [store.stats() for store in stores]
    assert stats[0] == stats[1]
    assert stores[0].digest() == stores[1].digest()
    assert stats[1]["evictions"] > 0 and stats[1]["lookups"]["hit"] > 0


def test_chain_hashes_and_digest_bit_equal_jax():
    rng = np.random.default_rng(9)
    tokens = rng.integers(-5, 2 ** 31 - 1, 300).tolist()
    for page, max_pages in ((4, 64), (32, 64), (32, 3)):
        assert chain_hashes(tokens, page, max_pages) \
            == jax_chain_hashes(tokens, page, max_pages)
    stores = [_store(impl, page=4, max_pages=8, num_pages=40)
              for impl in ("jax", "torch")]
    for store in stores:
        for cut in (8, 20, 32):
            store.insert(tokens[:cut], cut // 4)
        store.insert(tokens[100:132], 8)
    for entries in (512, 5):
        assert stores[0].digest(entries) == stores[1].digest(entries)
    digest = stores[1].digest()
    assert chain_hashes(tokens, 4, 8)[:8] == digest["entries"][1:9] \
        or set(chain_hashes(tokens, 4, 8)) <= set(digest["entries"])


# -- llama.prefill(prefix=) ---------------------------------------------------

def _rows_close(got, want, tol):
    """Each (batch row, position) within relative L2 ``tol``."""
    got = got.reshape(-1, got.shape[-1]) if got.ndim > 1 else got[None]
    want = want.reshape(got.shape)
    err = np.linalg.norm(got - want, axis=-1) \
        / np.maximum(np.linalg.norm(want, axis=-1), 1e-6)
    assert err.max() <= tol, err.max()


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jax_llama.init(jcfg,
                                                   jax.random.PRNGKey(0)))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_with_prefix_matches_jax(weights, dtype, int8):
    jcfg, tcfg = _cfgs(dtype, kv_int8=int8)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jcfg.dtype), weights)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(11)
    plen, s = 8, 8
    tokens = rng.integers(0, jcfg.vocab_size, (2, plen + s))
    lengths = np.array([5, 8], np.int32)
    # the prefix K/V: JAX's own prefill of the first plen tokens
    _, prefix_j, _ = jax_llama.prefill(
        jparams, jcfg, jnp.asarray(tokens[:, :plen]),
        jax_llama.init_cache(jcfg, 2, plen))
    prefix_np = jax.tree.map(np.asarray, prefix_j)
    logits_j, cache_j, len_j = jax_llama.prefill(
        jparams, jcfg, jnp.asarray(tokens[:, plen:]),
        jax_llama.init_cache(jcfg, 2, s), lengths=jnp.asarray(lengths),
        prefix=prefix_j, prefix_len=plen)
    prefix_t = {n: torch.from_numpy(np.array(a)) if int8
                else torch.from_numpy(np.array(a, np.float32)).to(
                    tcfg.dtype) for n, a in prefix_np.items()}
    logits_t, cache_t, len_t = pt_llama.prefill(
        tparams, tcfg, torch.from_numpy(tokens[:, plen:]),
        pt_llama.init_cache(tcfg, 2, s, device="cpu"),
        lengths=torch.from_numpy(lengths), prefix=prefix_t,
        prefix_len=plen)
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(len_t.numpy(), plen + lengths)
    got, want = logits_t.float().numpy(), np.asarray(logits_j, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        _rows_close(got, want, BF16_ROW_TOL)
    got = {n: leaf.float().numpy() for n, leaf in cache_t.items()}
    want = {n: np.asarray(leaf.astype(jnp.float32))
            for n, leaf in cache_j.items()}
    for name in ("k", "v"):
        if int8 and dtype == "f32":
            assert np.abs(got[name] - want[name]).max() <= 1
            np.testing.assert_allclose(got[name + "s"], want[name + "s"],
                                       rtol=1e-5)
        elif int8:       # bf16 rows round apart: dequantised, each row
            _rows_close(got[name] * got[name + "s"][..., None],
                        want[name] * want[name + "s"][..., None],
                        BF16_ROW_TOL)
        elif dtype == "f32":
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=1e-5)
        else:
            _rows_close(got[name], want[name], BF16_ROW_TOL)


def test_prefill_with_prefix_equals_the_full_prefill():
    """float32: the suffix's logits and K/V over the cached prefix are
    the full prompt's within float32 sum-order noise; the returned cache
    holds the suffix only and cache_len counts both."""
    _, tcfg = _cfgs()
    params = pt_llama.init(tcfg, 2, device="cpu")
    rng = np.random.default_rng(12)
    plen, s = 8, 8
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                           (2, plen + s)))
    lengths = torch.tensor([3, 8])
    full = pt_llama.init_cache(tcfg, 2, plen + s, device="cpu")
    logits, full, _ = pt_llama.prefill(params, tcfg, tokens, full,
                                       lengths=plen + lengths)
    prefix = {n: leaf[:, :, :plen] for n, leaf in full.items()}
    small = pt_llama.init_cache(tcfg, 2, s, device="cpu")
    got, small, cache_len = pt_llama.prefill(
        params, tcfg, tokens[:, plen:], small, lengths=lengths,
        prefix=prefix, prefix_len=plen)
    assert cache_len.tolist() == (plen + lengths).tolist()
    torch.testing.assert_close(got, logits, atol=1e-4, rtol=1e-4)
    for name, leaf in small.items():
        torch.testing.assert_close(leaf, full[name][:, :, plen:], atol=1e-5,
                                   rtol=1e-5)


def test_bf16_logits_tie_at_the_top_so_identity_needs_equal_bits():
    """Why greedy tokens with the store on equal those with it off only if
    the suffix prefill reproduces the full prefill's bits: the logits are
    the bf16 output of the head, so at the ``small`` preset's width the
    top two often tie exactly (14 of 256 rows here) or sit one bf16 ulp
    apart (31 of 256), and a difference in the last bit of either moves
    the argmax. Over the card's 7 x 32 greedy tokens a route that differs
    in the last bits (the mask form against the flash kernel, or GEMMs
    that split their sums by row count) flips a token with near
    certainty; observed there as a first difference at a margin of 0."""
    cfg = pt_llama.config("small", n_layers=2)
    params = pt_llama.init(cfg, 2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)))
    logits = pt_llama.forward(params, cfg, tokens).reshape(-1,
                                                           cfg.vocab_size)
    assert torch.equal(logits, logits.bfloat16().float())     # bf16 values
    top = torch.topk(logits, 2).values
    gap = top[:, 0] - top[:, 1]
    ulp = torch.finfo(torch.bfloat16).eps * top[:, 0].abs()
    assert (gap == 0).sum() >= 8
    assert (gap <= ulp).sum() >= 20
    # one ulp more on the runner-up moves the argmax of a tied row
    row = int(torch.nonzero(gap == 0)[0])
    winner = int(logits[row].argmax())            # the first of the tied
    tied = torch.nonzero(logits[row] == top[row, 0])[:, 0].tolist()
    other = next(i for i in tied if i != winner)
    nudged = logits[row].clone()
    nudged[other] += ulp[row]
    assert int(nudged.argmax()) == other


# -- the engines against JAX's ------------------------------------------------

BASE = list(range(1, 11))             # 10 tokens: 2 full pages + tail
SEQUENCE = [BASE, BASE, BASE[:8] + [31, 32, 33], BASE[:8]]
WAVE = [list(range(1, 9)) + [70 + i] for i in range(3)]
VARIANTS = {"plain": (False, False), "int8": (True, False),
            "spec": (False, True)}


async def _serve(engine):
    """SEQUENCE one at a time (misses, hits, a partial hit, a page
    boundary), then WAVE twice, each wave concurrent."""
    await engine.start()
    try:
        outs = []
        for prompt in SEQUENCE:
            outs.append(await asyncio.wait_for(
                engine.generate(prompt, max_new_tokens=6), 60.0))
        for _ in range(2):
            outs += await asyncio.wait_for(asyncio.gather(*[
                engine.generate(p, max_new_tokens=4) for p in WAVE]), 60.0)
        return outs, engine.stats()["prefix_cache"]
    finally:
        await engine.stop()


def _variant_kw(variant, paged, draft):
    kw = dict(paged_kv=True, kv_page=4) if paged else {}
    if VARIANTS[variant][1]:
        kw.update(draft_cfg=draft[0], draft_params=draft[1], spec_gamma=2)
    return kw


@pytest.fixture(scope="module")
def jax_runs(weights):
    jcfg, _ = _cfgs(use_flash=True)
    jdcfg = dataclasses.replace(jcfg, n_layers=1)
    jdraft = jax.tree.map(np.asarray,
                          jax_llama.init(jdcfg, jax.random.PRNGKey(7)))
    out = {}
    for variant, (int8, _) in VARIANTS.items():
        for paged in (False, True):
            container = new_mock_container()
            engine = JaxEngine(
                dataclasses.replace(jcfg, kv_int8=int8), weights,
                logger=container.logger, metrics=container.metrics,
                prefix_cache=True, **ENGINE_KW,
                **_variant_kw(variant, paged, (jdcfg, jdraft)))
            out[variant, paged] = asyncio.run(_serve(engine))
    out["draft"] = (dataclasses.replace(_cfgs(use_flash=True)[1],
                                        n_layers=1),
                    from_jax_llama(jdraft, "cpu"))
    return out


STAT_KEYS = ("lookups", "tokens_saved", "inserts", "adoptions",
             "used_pages", "evictions", "page_ladder", "num_pages",
             "shared_pool")


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_with_prefix_cache_matches_jax(weights, jax_runs, variant,
                                              paged):
    int8, _ = VARIANTS[variant]
    _, tcfg = _cfgs(use_flash=True, kv_int8=int8)
    engine = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                              device="cpu", prefix_cache=True, **ENGINE_KW,
                              **_variant_kw(variant, paged,
                                            jax_runs["draft"]))
    outs, stats = asyncio.run(_serve(engine))
    want_outs, want_stats = jax_runs[variant, paged]
    assert outs == want_outs
    for key in STAT_KEYS:
        assert stats[key] == want_stats[key], key
    assert stats["lookups"]["hit"] >= 5 and stats["tokens_saved"] > 0


# -- the engine alone ---------------------------------------------------------

def _engine(params, dtype="bf16", prefix=True, paged=False, **kw):
    _, tcfg = _cfgs(dtype, use_flash=True)
    layout = dict(paged_kv=True, kv_page=4) if paged else {}
    return GenerationEngine(tcfg, params, device="cpu", prefix_cache=prefix,
                            **{**ENGINE_KW, **layout, **kw})


@pytest.mark.parametrize("paged", [False, True])
def test_bf16_tokens_equal_with_the_cache_on_and_off(weights, paged):
    params = from_jax_llama(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), weights), "cpu")
    on = asyncio.run(_serve(_engine(params, paged=paged)))
    off_engine = _engine(params, prefix=False, paged=paged)

    async def serve_off():
        await off_engine.start()
        try:
            outs = []
            for prompt in SEQUENCE:
                outs.append(await off_engine.generate(prompt, 6))
            for _ in range(2):
                outs += await asyncio.gather(*[
                    off_engine.generate(p, 4) for p in WAVE])
            return outs
        finally:
            await off_engine.stop()
    assert on[0] == asyncio.run(serve_off())
    assert on[1]["lookups"]["hit"] >= 5


async def _sequential(engine, prompts, n):
    await engine.start()
    try:
        return [await asyncio.wait_for(engine.generate(p, n), 60.0)
                for p in prompts], engine.stats()
    finally:
        await engine.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_suffix_prefill_dispatches_fewer_prompt_tokens(weights, paged):
    params = from_jax_llama(weights, "cpu")
    shared = list(range(1, 9))                    # 2 pages of 4
    prompts = [shared + [50 + i, 60 + i] for i in range(4)]
    ref, off = asyncio.run(_sequential(
        _engine(params, "f32", prefix=False, paged=paged), prompts, 4))
    out, on = asyncio.run(_sequential(
        _engine(params, "f32", paged=paged), prompts, 4))
    assert out == ref
    assert on["prefill_bucket_tokens"] < off["prefill_bucket_tokens"]
    assert on["prefix_cache"]["tokens_saved"] == 24   # 3 of 4 reused 8


@pytest.mark.parametrize("paged", [False, True])
def test_concurrent_admissions_share_one_prefix(weights, paged):
    """One pass of identical heads: all miss (no K/V yet), the first
    row's pages win, the next wave hits."""
    params = from_jax_llama(weights, "cpu")

    async def run(engine):
        await engine.start()
        try:
            outs = []
            for _ in range(2):
                outs += await asyncio.wait_for(asyncio.gather(*[
                    engine.generate(p, 4) for p in WAVE]), 60.0)
            return outs, engine.stats().get("prefix_cache")
        finally:
            await engine.stop()
    ref, _ = asyncio.run(run(_engine(params, "f32", False, paged)))
    out, store = asyncio.run(run(_engine(params, "f32", True, paged)))
    assert out == ref
    assert store["inserts"] == 2 and store["used_pages"] == 2
    assert store["lookups"]["hit"] >= 3


@pytest.mark.parametrize("paged", [False, True])
def test_eviction_under_tight_budget_keeps_outputs_exact(weights, paged):
    """Dense: a store pool of 3 pages; paged: an engine pool of 8 pages
    (reserve 1) that prefixes and decode share, a slot taking 4 of them.
    Each prompt wants 2 prefix pages: serving all four twice churns
    through eviction."""
    params = from_jax_llama(weights, "cpu")
    prompts = [[10 * k + i for i in range(1, 11)] for k in range(4)] * 2
    kw = dict(kv_pages=8, kv_page_reserve=1) if paged else {}
    ref, _ = asyncio.run(_sequential(
        _engine(params, "f32", False, paged, **kw), prompts, 4))
    engine = _engine(params, "f32", True, paged, **kw)
    if not paged:
        engine._prefix.num_pages = 3
        engine._prefix.reset()
    out, stats = asyncio.run(_sequential(engine, prompts, 4))
    assert out == ref
    store = stats["prefix_cache"]
    assert store["evictions"] > 0
    assert store["used_pages"] <= (3 if not paged else 8)
    if paged:
        assert stats["kv_pool"]["used_pages"] == store["used_pages"]


@pytest.mark.parametrize("paged", [False, True])
def test_reset_device_state_invalidates_store(weights, paged):
    params = from_jax_llama(weights, "cpu")
    prompt = list(range(1, 11))

    async def run():
        engine = _engine(params, "f32", True, paged)
        await engine.start()
        try:
            ref = await engine.generate(prompt, 4)
            assert engine._prefix.used_pages == 2
            engine._reset_device_state()
            assert engine._prefix.used_pages == 0
            assert engine._prefix.lookup(prompt) == []
            # the store fills again and still serves exact tokens
            assert await engine.generate(prompt, 4) == ref
            assert await engine.generate(prompt, 4) == ref
            assert engine._prefix.used_pages == 2
            assert engine.stats()["prefix_cache"]["lookups"]["hit"] == 1
        finally:
            await engine.stop()
    asyncio.run(run())


def test_prefix_digest_and_stats_ladder(weights):
    params = from_jax_llama(weights, "cpu")
    engine = _engine(params, "f32", True, False)
    assert engine.stats()["prefix_cache"]["page_ladder"] == [1, 2, 4]
    assert engine.prefix_digest()["entries"] == []
    asyncio.run(_sequential(engine, [BASE], 2))
    digest = engine.prefix_digest()
    assert digest["entries"] == chain_hashes(BASE, 4)
    assert _engine(params, "f32", False).prefix_digest() is None
    paged = _engine(params, "f32", True, True, kv_page=8,
                    prompt_buckets=(8, 16))
    # the paged store's page is the pool's
    assert paged.stats()["prefix_cache"]["page_tokens"] == 8
    assert paged.stats()["prefix_cache"]["shared_pool"]


def test_publish_in_place_waits_for_queued_suffix_prefills(weights):
    """The dense store publishes into its pool in place. Hold the device
    thread while a long request's ticks are in flight; admit B, a hit on
    A's two cached pages (its suffix prefill reads them), then in the
    next pass D, whose full prefill evicts both pages and publishes its
    own K/V into the same page ids. Both prefills are queued behind the
    held ticks. Released, B reads A's K/V (queued first) and every
    request's tokens are the cache-off engine's."""
    params = from_jax_llama(weights, "cpu")
    a = list(range(1, 11))
    b = a[:8] + [40, 41]
    d = list(range(20, 30))
    long = [7, 8, 9]

    async def run(engine, hold):
        await engine.start()
        try:
            first = await engine.generate(a, 4)
            stream = await engine.generate_stream(long, 40)
            got = [await stream.__anext__() for _ in range(2)]
            gate = threading.Event()
            if hold:
                engine._device_exec.submit(gate.wait)
                # B and D wait in the queue; each admission pass takes one
                admit = engine._admit_pending

                def one_a_pass(loop):
                    queued = list(engine._pending.drain())
                    for cls, req in queued[:1]:
                        engine._pending.put_nowait(req, cls)
                    admit(loop)
                    for cls, req in queued[1:]:
                        engine._pending.put_nowait(req, cls)
                engine._admit_pending = one_a_pass
            tasks = [asyncio.ensure_future(engine.generate(p, 6))
                     for p in (b, d)]
            if hold:
                while engine.prefill_dispatches < 4:
                    await asyncio.sleep(0.01)
                store = engine._prefix
                assert store.hits == 1 and store.evictions == 2
                gate.set()
            rest = await asyncio.wait_for(asyncio.gather(*tasks), 60.0)
            got += [tok async for tok in stream]
            return [first, got] + rest
        finally:
            await engine.stop()

    engine = _engine(params, "f32", True, False, max_inflight_ticks=4)
    engine._prefix.num_pages = 2
    engine._prefix.reset()
    claims = []
    claim = engine._claim_group

    def recorded(*args):
        out = claim(*args)
        claims.append(dict(layout=out[1][5], ints=out[1][4]))
        return out
    engine._claim_group = recorded
    out = asyncio.run(run(engine, hold=True))
    ref = asyncio.run(run(_engine(params, "f32", False, False,
                                  max_inflight_ticks=4), hold=False))
    assert out == ref

    def ids(entry, name):
        at = 0
        for key, shape in entry["layout"]:
            n = int(np.prod(shape))
            if key == name:
                return set(entry["ints"][at:at + n].tolist())
            at += n
        return set()
    read = ids(claims[2], "prefix_ids")
    written = ids(claims[3], "publish_ids") - {2}
    assert len(read) == 2 and read == written
