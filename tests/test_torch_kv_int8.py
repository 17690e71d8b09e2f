"""Port parity for the int8 KV configuration (``LlamaConfig.kv_int8``) of
the paged engine, against the JAX package on the CPU.

- ``quantize_kv``: bit-identical to JAX on float32 and bf16 rows, zero
  rows included.
- The int8 plain ragged decode and verify (G 1, 3, 5; group 1 and 2)
  against JAX ``ragged_paged_{decode,verify}_attention`` (Pallas, in
  interpret mode) and against the JAX gather oracle. NaN in the scale
  planes of every unreferenced page leaves both packages finite and
  unchanged; NaN in the scale rows past each fill leaves the port
  unchanged (the JAX kernel reads the dead rows of a partly filled page,
  ROADMAP §3, so only the port is held to that).
- ``prefill``, ``decode_step_paged`` and ``verify_step_paged`` with
  ``kv_int8`` against JAX (``ragged=True``), logits and pool leaves.
- ``PagePool``'s int8 leaves and its page bytes against JAX's.
- Greedy token identity of the port's int8 engine with the JAX int8
  paged engine (``ragged_attn="on"``, steps per tick 1 and 4), and of the
  int8-target speculative engine (float32 draft, the target's weights or
  its own) with the JAX speculative engine; every page comes back.
- A ``kv_int8`` draft is served (the ragged route over its identity
  tables); the flash-decode route with ``kv_int8`` is refused.

Bounds as in test_torch_ragged_paged_attention: f32 ``atol=rtol=1e-5``,
bf16 one ulp ``atol=rtol=1.6e-2``; model logits ``atol=1e-4`` (float32,
as in test_torch_llama). Pool K/V: the int8 rows of two float32 forwards
summed in other orders may land on opposite sides of a rounding
half-way point, so the int8 leaves may differ by one step where the
scales agree to ``rtol=1e-6``; one step is the whole quantisation error,
and the dequantised rows are held to ``atol=1e-5`` plus one step.
"""

import asyncio
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.ops.pallas import (ragged_paged_decode_attention as jax_decode,
                                 ragged_paged_verify_attention as jax_verify)
from gofr_tpu.ops.quant import quantize_kv as jax_quantize_kv
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.page_pool import PagePool as JaxPagePool
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as pt_ragged
from gofr_tpu_torch.ops.quant import quantize_kv
from gofr_tpu_torch.tpu.generate import GenerationEngine
from gofr_tpu_torch.tpu.page_pool import PagePool

jax_attn = importlib.import_module("gofr_tpu.ops.attention")

NUM_PAGES, PAGE, HKV, D, P = 12, 16, 2, 16, 4
SENTINEL = NUM_PAGES
FILLS = [0, 1, 15, 16, 17, 32, 40]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


# -- quantize_kv ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_quantize_kv_bit_identical_to_jax(name):
    jdt, tdt, _ = DTYPES[name]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 7, 2, 128)) * 4).astype(np.float32)
    x[0, 0] = 0.0                     # whole zero vectors: scale 1
    x[1, 2, 1] = 0.0
    x[2, 3, 0, :4] = [127.0, -63.5, 0.5, -0.5]   # half-way quotients
    jq, js = jax_quantize_kv(jnp.asarray(x, jdt))
    tq, ts = quantize_kv(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == x.shape and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[0, 0] == 1.0).all() and (tq[0, 0] == 0).all()


# -- the int8 ragged kernel's plain versions -----------------------------------

def _scenario(fills, g_len, group, seed=0):
    """int8 pools quantised from random rows with their scale planes, a
    page table covering each fill (pages handed out bottom-up, sentinel
    tails), q (B,G,Hq,D), new K/V (B,G,Hkv,D) and the fills; numpy."""
    rng = np.random.default_rng(seed)
    b = len(fills)
    shape = (NUM_PAGES, PAGE, HKV, D)
    kq, ks = quantize_kv(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))
    vq, vs = quantize_kv(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))
    q = rng.standard_normal((b, g_len, HKV * group, D)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((b, g_len, HKV, D))
                    .astype(np.float32) for _ in range(2))
    table = np.full((b, P), SENTINEL, np.int32)
    nxt = 0
    for row, n in enumerate(fills):
        for col in range(-(-n // PAGE)):
            table[row, col] = nxt
            nxt += 1
    assert nxt < NUM_PAGES
    return dict(q=q, kq=kq.numpy(), vq=vq.numpy(), ks=ks.numpy(),
                vs=vs.numpy(), table=table, k_new=k_new, v_new=v_new,
                lens=np.asarray(fills, np.int32))


def _poison(sc, past_fill=False):
    """A copy of the scenario with NaN scales on every page no table row
    references and, with ``past_fill``, on every scale row at or past a
    slot's fill."""
    sc = dict(sc, ks=sc["ks"].copy(), vs=sc["vs"].copy())
    used = {int(p) for p in sc["table"].ravel() if p != SENTINEL}
    for pid in set(range(NUM_PAGES)) - used:
        sc["ks"][pid] = sc["vs"][pid] = np.nan
    if past_fill:
        for row, n in enumerate(sc["lens"]):
            if n % PAGE:
                pid = sc["table"][row, n // PAGE]
                sc["ks"][pid, n % PAGE:] = sc["vs"][pid, n % PAGE:] = np.nan
    return sc


def _run_jax(sc, name, fn):
    jdt = DTYPES[name][0]
    g1 = sc["q"].shape[1] == 1
    kn, vn = (sc[key][:, 0] if g1 else sc[key] for key in ("k_new", "v_new"))
    args = [jnp.asarray(sc["q"], jdt), jnp.asarray(sc["kq"]),
            jnp.asarray(sc["vq"]), jnp.asarray(sc["table"]),
            jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
            jnp.asarray(sc["lens"])]
    scales = dict(k_scale_pages=jnp.asarray(sc["ks"]),
                  v_scale_pages=jnp.asarray(sc["vs"]))
    return np.asarray(fn(*args, **scales), np.float32)


def _run_port(sc, name, wrapper=False):
    tdt = DTYPES[name][1]
    g1 = sc["q"].shape[1] == 1
    kn, vn = (sc[key][:, 0] if g1 else sc[key] for key in ("k_new", "v_new"))
    if wrapper:
        fn = (pt_ragged.ragged_paged_decode_attention if g1
              else pt_ragged.ragged_paged_verify_attention)
    else:
        fn = (pt_ragged.ragged_paged_decode_attention_plain if g1
              else pt_ragged.ragged_paged_verify_attention_plain)
    out = fn(torch.from_numpy(sc["q"]).to(tdt), torch.from_numpy(sc["kq"]),
             torch.from_numpy(sc["vq"]), torch.from_numpy(sc["table"]),
             torch.from_numpy(np.ascontiguousarray(kn)).to(tdt),
             torch.from_numpy(np.ascontiguousarray(vn)).to(tdt),
             torch.from_numpy(sc["lens"]), torch.from_numpy(sc["ks"]),
             torch.from_numpy(sc["vs"]))
    return out.float().numpy()


def _jax_fns(g_len):
    if g_len == 1:
        return (lambda *a, **kw: jax_decode(*a, interpret=True, **kw),
                jax_attn.paged_decode_attention)
    return (lambda *a, **kw: jax_verify(*a, interpret=True, **kw),
            jax_attn.paged_verify_attention)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("g_len", [1, 3, 5])
def test_int8_plain_matches_pallas_interpret_and_gather_oracle(
        name, group, g_len):
    sc = _scenario(FILLS, g_len, group, seed=10 * g_len + group)
    tol = DTYPES[name][2]
    out = _run_port(sc, name)
    assert out.shape == sc["q"].shape
    for fn in _jax_fns(g_len):
        np.testing.assert_allclose(_run_jax(sc, name, fn), out, atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("g_len", [1, 3])
def test_int8_nan_scales_never_reach_the_output(name, g_len):
    sc = _scenario(FILLS, g_len, 2, seed=7)
    tol = DTYPES[name][2]
    clean = _run_port(sc, name)
    kernel_fn = _jax_fns(g_len)[0]
    # whole unreferenced pages: both packages
    pages = _poison(sc)
    out = _run_port(pages, name)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, clean)
    kernel = _run_jax(pages, name, kernel_fn)
    assert np.isfinite(kernel).all()
    np.testing.assert_allclose(kernel, out, atol=tol, rtol=tol)
    # the rows past each fill too: the port only
    tails = _run_port(_poison(sc, past_fill=True), name)
    np.testing.assert_array_equal(tails, clean)


def test_int8_wrapper_on_cpu_is_the_plain_version():
    sc = _poison(_scenario(FILLS, 1, 2, seed=8), past_fill=True)
    before = (pt_ragged.launches, pt_ragged.int8_launches)
    np.testing.assert_array_equal(_run_port(sc, "bf16", wrapper=True),
                                  _run_port(sc, "bf16"))
    sc3 = _scenario(FILLS, 3, 2, seed=8)
    np.testing.assert_array_equal(_run_port(sc3, "bf16", wrapper=True),
                                  _run_port(sc3, "bf16"))
    assert (pt_ragged.launches, pt_ragged.int8_launches) == before


# -- model steps ---------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, kv_int8=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, kv_int8=True)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _assert_pools_close(jpool, tpool):
    """int8 leaves within one quantisation step where the scales agree;
    the dequantised rows within 1e-5 plus one step."""
    for name in ("ks", "vs"):
        np.testing.assert_allclose(np.asarray(jpool[name]),
                                   tpool[name].numpy(), rtol=1e-6)
    for name in ("k", "v"):
        jq = np.asarray(jpool[name]).astype(np.int32)
        tq = tpool[name].numpy().astype(np.int32)
        assert np.abs(jq - tq).max() <= 1
        assert (jq != tq).mean() < 1e-3
        scale = tpool[name + "s"].numpy()[..., None]
        np.testing.assert_allclose(jq * scale, tq * scale,
                                   atol=1e-5 + scale.max())


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_init_cache_and_prefill_int8(models):
    jcfg, jparams, tcfg, tparams = models
    cache = pt_llama.init_cache(tcfg, 3, 8, device="cpu")
    assert {k: (v.dtype, tuple(v.shape)) for k, v in cache.items()} == {
        "k": (torch.int8, (2, 3, 8, 2, 16)),
        "v": (torch.int8, (2, 3, 8, 2, 16)),
        "ks": (torch.float32, (2, 3, 8, 2)),
        "vs": (torch.float32, (2, 3, 8, 2))}
    assert (cache["ks"] == 1).all() and (cache["vs"] == 1).all()
    tokens = _tokens((3, 8), seed=1)
    lengths = np.array([5, 8, 3], np.int32)
    jlogits, jcache, _ = jax_llama.prefill(
        jparams, jcfg, jnp.asarray(tokens), jax_llama.init_cache(jcfg, 3, 8),
        lengths=jnp.asarray(lengths))
    tlogits, tcache, tlen = pt_llama.prefill(
        tparams, tcfg, torch.from_numpy(tokens).long(), cache,
        lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                               atol=1e-4)
    assert tlen.tolist() == lengths.tolist()
    _assert_pools_close(jcache, tcache)


def _with_scratch(leaf):
    """A pool leaf with the port's scratch page row after its pages (the
    sentinel id's row, which dropped writes land in)."""
    return torch.from_numpy(np.concatenate(
        [leaf, np.zeros_like(leaf[:, :1])], axis=1))


def _paged_setup(models, g_len):
    """Prefill three prompts (JAX), place their quantised KV in pool pages
    with room for ``g_len`` more tokens each."""
    jcfg, jparams, tcfg, _ = models
    tokens = _tokens((3, 8), seed=2)
    lengths = np.array([5, 8, 3], np.int32)
    jl, jc, _ = jax_llama.prefill(
        jparams, jcfg, jnp.asarray(tokens), jax_llama.init_cache(jcfg, 3, 8),
        lengths=jnp.asarray(lengths))
    small = {name: np.asarray(leaf) for name, leaf in jc.items()}
    pool = {name: np.array(leaf) for name, leaf in
            JaxPagePool(jcfg, page=4, num_pages=16).leaves.items()}
    table = np.full((3, 4), 16, np.int32)
    nxt = 0
    for row, n in enumerate(lengths):
        for col in range(-(-(int(n) + g_len) // 4)):
            table[row, col] = nxt
            lo, hi = col * 4, min((col + 1) * 4, int(n))
            for name in pool:
                if hi > lo:
                    pool[name][:, nxt, :hi - lo] = small[name][:, row, lo:hi]
            nxt += 1
    return jl, pool, table, lengths


def test_decode_step_paged_int8_matches_jax(models):
    """Three steps with one inactive row (its appends must be dropped)."""
    jcfg, jparams, tcfg, tparams = models
    jl, pool, table, lengths = _paged_setup(models, 3)
    active = np.array([True, True, False])
    step = jax.jit(lambda p, tok, pl, tb, cl, act: jax_llama.decode_step_paged(
        p, jcfg, tok, pl, tb, cl, act, ragged=True))
    jpool = {name: jnp.asarray(a) for name, a in pool.items()}
    tpool = {name: _with_scratch(a) for name, a in pool.items()}
    jlen, tlen = jnp.asarray(lengths), torch.from_numpy(lengths)
    token = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jlogits, jpool, jnew = step(jparams, jnp.asarray(token), jpool,
                                    jnp.asarray(table), jlen,
                                    jnp.asarray(active))
        tlogits, tpool, tnew = pt_llama.decode_step_paged(
            tparams, tcfg, torch.from_numpy(token).long(), tpool,
            torch.from_numpy(table), tlen, torch.from_numpy(active))
        np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                                   atol=1e-4)
        jlen = jnp.where(jnp.asarray(active), jnew, jlen)
        tlen = torch.where(torch.from_numpy(active), tnew, tlen)
        token = np.asarray(jlogits).argmax(-1).astype(np.int32)
    _assert_pools_close(jpool, {name: leaf[:, :16]
                                for name, leaf in tpool.items()})
    # the inactive row's page holds its prompt rows only
    first = table[2, 0]
    assert (tpool["k"][:, first, 3:] == 0).all()
    assert (tpool["ks"][:, first, 3:] == 1).all()


def test_verify_step_paged_int8_matches_jax(models):
    """Three rows, G = 3, the last row inactive (it must not write)."""
    jcfg, jparams, tcfg, tparams = models
    g_len = 3
    _, pool, table, lengths = _paged_setup(models, g_len)
    active = np.array([True, True, False])
    tokens = _tokens((3, g_len), seed=6)
    jlogits, jpool = jax.jit(
        lambda p, tok, pl, tb, cl, act: jax_llama.verify_step_paged(
            p, jcfg, tok, pl, tb, cl, act, ragged=True))(
        jparams, jnp.asarray(tokens),
        {name: jnp.asarray(a) for name, a in pool.items()},
        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(active))
    tpool = {name: _with_scratch(a) for name, a in pool.items()}
    tlogits, tpool = pt_llama.verify_step_paged(
        tparams, tcfg, torch.from_numpy(tokens).long(), tpool,
        torch.from_numpy(table), torch.from_numpy(lengths),
        torch.from_numpy(active))
    assert tlogits.shape == (3, g_len, tcfg.vocab_size)
    np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                               atol=1e-4)
    _assert_pools_close(jpool, {name: leaf[:, :16]
                                for name, leaf in tpool.items()})
    for name in pool:
        np.testing.assert_array_equal(tpool[name][:, table[2, 0]].numpy(),
                                      pool[name][:, table[2, 0]])


def test_page_pool_int8_leaves_and_bytes(models):
    jcfg, _, tcfg, _ = models
    pool = PagePool(tcfg, page=4, num_pages=3, device="cpu")
    # three usable pages and the scratch page at the sentinel id
    assert {k: (v.dtype, tuple(v.shape)) for k, v in pool.leaves.items()} == {
        "k": (torch.int8, (2, 4, 4, 2, 16)),
        "v": (torch.int8, (2, 4, 4, 2, 16)),
        "ks": (torch.float32, (2, 4, 4, 2)),
        "vs": (torch.float32, (2, 4, 4, 2))}
    assert not pool.leaves["k"].any() and (pool.leaves["vs"] == 1).all()
    pool.leaves["vs"].zero_()
    pool.reset()                                  # in place, scales at one
    assert (pool.leaves["vs"] == 1).all()
    assert pool.page_bytes == JaxPagePool._page_bytes(jcfg, 4) \
        == 2 * (2 * 4 * 2 * 16 + 2 * 4 * 2 * 4)
    assert pool.stats()["pool_bytes"] == 3 * pool.page_bytes
    # the same page count holds 264/512 of the bf16 pool's bytes at the
    # llama3-8b geometry (head_dim 128)
    big = pt_llama.config("llama3-8b", kv_int8=True)
    bf16 = pt_llama.config("llama3-8b")
    assert PagePool._page_bytes(big, 32) == 2_162_688
    assert PagePool._page_bytes(bf16, 32) == 4_194_304
    jbig = jax_llama.config("llama3-8b", kv_int8=True)
    assert JaxPagePool._page_bytes(jbig, 32) == 2_162_688


# -- engine --------------------------------------------------------------------

PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 11)), [9, 8, 7]]
BUDGET = 8
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 paged_kv=True, kv_page=4)


async def _serve(engine, prompts, concurrent=False):
    await engine.start()
    try:
        if concurrent:
            return list(await asyncio.wait_for(asyncio.gather(
                *[engine.generate(p, max_new_tokens=BUDGET)
                  for p in prompts]), 120.0))
        return [await asyncio.wait_for(
            engine.generate(p, max_new_tokens=BUDGET), 120.0)
            for p in prompts]
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def engines():
    """The JAX int8 engine's greedy output, plain and speculative (a
    float32 draft: the target's own weights, or its own), computed once."""
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True,
                            kv_int8=True)
    jdcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    jdraft = jax_llama.init(jdcfg, jax.random.PRNGKey(7))
    drafts = {"self": jparams, "other": jdraft}
    reference = {}
    container = new_mock_container()
    engine = JaxEngine(jcfg, jparams, logger=container.logger,
                       metrics=container.metrics,
                       ragged_attn="on", **ENGINE_KW)
    reference["plain"] = asyncio.run(_serve(engine, PROMPTS))
    for name, jd in drafts.items():
        container = new_mock_container()
        engine = JaxEngine(jcfg, jparams, logger=container.logger,
                           metrics=container.metrics,
                           ragged_attn="on", draft_cfg=jdcfg,
                           draft_params=jd, spec_gamma=4, **ENGINE_KW)
        reference[name] = asyncio.run(_serve(engine, PROMPTS,
                                             concurrent=True))
        assert engine.stats()["speculative"]["spec_ticks"] > 0
    to_pt = lambda p: from_jax_llama(jax.tree.map(np.asarray, p), "cpu")
    return dict(cfg=pt_llama.config("tiny", dtype=torch.float32,
                                    use_flash=True, kv_int8=True),
                dcfg=pt_llama.config("tiny", dtype=torch.float32,
                                     use_flash=True),
                params=to_pt(jparams),
                drafts={name: to_pt(jd) for name, jd in drafts.items()},
                reference=reference)


@pytest.mark.parametrize("steps_per_tick", [1, 4])
def test_int8_engine_greedy_identity_with_jax(engines, steps_per_tick):
    engine = GenerationEngine(engines["cfg"], engines["params"],
                              device="cpu", steps_per_tick=steps_per_tick,
                              **ENGINE_KW)
    assert asyncio.run(_serve(engine, PROMPTS)) \
        == engines["reference"]["plain"]
    stats = engine.stats()
    assert stats["prefill_dispatches"] == len(PROMPTS)
    pool = stats["kv_pool"]
    assert pool["used_pages"] == 0                   # every page came back
    assert pool["page_bytes"] == 2 * (2 * 4 * 2 * 16 + 2 * 4 * 2 * 4)
    assert pool["pool_bytes"] == pool["num_pages"] * pool["page_bytes"]
    assert engine._pool.leaves["k"].dtype == torch.int8


@pytest.fixture(scope="module")
def jax_int8_at_depth():
    """The JAX int8 engine's concurrent greedy output at a pipeline depth
    and steps per tick, each computed once."""
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True,
                            kv_int8=True)
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


@pytest.mark.parametrize("steps_per_tick", [1, 4])
@pytest.mark.parametrize("inflight", [1, 2, 4])
def test_int8_engine_greedy_identity_at_depth(engines, jax_int8_at_depth,
                                              inflight, steps_per_tick):
    engine = GenerationEngine(engines["cfg"], engines["params"],
                              device="cpu", steps_per_tick=steps_per_tick,
                              max_inflight_ticks=inflight, **ENGINE_KW)
    out = asyncio.run(_serve(engine, PROMPTS, concurrent=True))
    assert out == jax_int8_at_depth(inflight, steps_per_tick) \
        == engines["reference"]["plain"]
    stats = engine.stats()
    assert min(inflight, 2) <= stats["ticks_inflight_peak"] <= inflight
    assert stats["kv_pool"]["used_pages"] == 0


@pytest.mark.parametrize("draft", ["self", "other"])
def test_int8_spec_engine_greedy_identity_with_jax(engines, draft):
    engine = GenerationEngine(
        engines["cfg"], engines["params"], device="cpu",
        draft_cfg=engines["dcfg"], draft_params=engines["drafts"][draft],
        spec_gamma=4, **ENGINE_KW)
    out = asyncio.run(_serve(engine, PROMPTS, concurrent=True))
    assert out == engines["reference"][draft] \
        == engines["reference"]["plain"]
    st = engine.stats()
    assert st["speculative"]["spec_ticks"] > 0
    if draft == "self":
        # the int8 target against its own float32 weights as the draft:
        # cache precision makes them disagree now and then, not often
        assert st["speculative"]["accepted"] \
            >= 0.5 * st["speculative"]["proposed"]
    assert st["kv_pool"]["used_pages"] == 0
    assert engine._draft_cache["k"].dtype == torch.float32


def test_kv_int8_draft_and_dense_decode_step_are_refused(engines):
    """A ``kv_int8`` draft is taken as given, as the JAX engine takes it:
    it decodes through the ragged route over its own identity tables,
    its dense cache int8 with its scale planes (its parity with JAX:
    tests/test_torch_compiled_prefill.py). What stays refused is the
    flash-decode route over an int8 cache, as in JAX."""
    engine = GenerationEngine(engines["cfg"], engines["params"],
                              device="cpu", draft_cfg=engines["cfg"],
                              draft_params=engines["params"], **ENGINE_KW)
    assert not engine.draft_cfg.use_flash_decode
    assert engine._draft_cache["k"].dtype == torch.int8
    assert set(engine._draft_cache) == {"k", "v", "ks", "vs"}
    assert set(engine._draft_tables) == set(engine._window_ladder)
    # the dense step's flash-decode route reads a bf16 cache: an int8
    # config cannot take it (the dense int8 step runs the ragged route,
    # tests/test_torch_dense.py)
    with pytest.raises(ValueError, match="kv_int8"):
        dataclasses.replace(engines["cfg"], use_flash_decode=True)
