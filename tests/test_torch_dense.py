"""Port parity for the dense-cache engine, the JAX engine's default
(``paged_kv=False``), and its attention-window ladder.

- ``decode_step`` / ``verify_step`` (G 2 and 5) at each rung of the
  ``tiny`` preset's ladder at ``max_seq_len`` 512 (128, 256, None), over
  bf16 and ``kv_int8`` caches, against JAX ``llama.decode_step`` /
  ``verify_step``, with one row's fill past the rung (an inactive slot
  attends the whole window, JAX's ``v[:, :window]``): at float32 the
  logits within ``atol=1e-4`` and the same argmax, at bf16 within a
  relative L2 of 2e-2 over each row (the two packages round the bf16
  activations of two layers differently); the written cache rows equal
  (float32 ``atol=1e-5``; int8 within one quantisation step, scales
  ``rtol=1e-5``; bf16 each row, dequantised, within the same 2e-2),
  every other row untouched.
- Positions past the cache are dropped, as JAX's ``mode="drop"``.
- The identity-table route alone: the ragged wrappers' plain versions
  over the dense cache viewed as pages equal JAX
  ``decode_attention_cached`` / ``verify_attention`` over the window's
  view, bf16 and int8 (f32 ``atol=rtol=1e-5``, bf16 one ulp
  ``1.6e-2``), and the port's own dense oracle bit for bit.
- Flash decode's plain version over a window view equals it over the
  same positions copied out; the wrapper's view predicate.
- The engines against the JAX dense engine at float32: greedy
  completions identical for plain, spec (a 1-layer draft, γ 1),
  ``kv_int8`` and ``kv_int8`` spec, at steps per tick 1 and 4 and 1 and 2 ticks in
  flight, over prompts whose fills cross 128 and 256, with the rung of
  every tick equal to JAX's ``_pick_window`` for the same fills.
- ``warmup(windows=...)`` and ``stats()["window_ladder"]`` as JAX's.
- ``cuda_refusals`` for the dense mode (the predicate; it runs on the
  CPU).

Each JAX reference runs once per module.
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
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention, ragged_paged_verify_attention)
from gofr_tpu_torch.ops import attention as pt_attention
from gofr_tpu_torch.tpu.generate import GenerationEngine, cuda_refusals

jax_attn = importlib.import_module("gofr_tpu.ops.attention")

MAX_LEN = 512
RUNGS = [128, 256, None]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ROW_TOL = 2e-2


def _cfgs(name, int8, **over):
    jdt, tdt = DTYPES[name]
    over = dict(max_seq_len=MAX_LEN, kv_int8=int8, **over)
    return (jax_llama.config("tiny", dtype=jdt, **over),
            pt_llama.config("tiny", dtype=tdt, **over))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs("f32", False)
    return jax.tree.map(np.asarray,
                        jax_llama.init(jcfg, jax.random.PRNGKey(0)))


def _params(weights, name):
    jp = jax.tree.map(lambda a: jnp.asarray(a, DTYPES[name][0]), weights)
    return jp, from_jax_llama(jax.tree.map(np.asarray, jp), "cpu")


def _scale_or_int8(name, array):
    return array.dtype == np.int8 or name in ("ks", "vs")


def _cache(cfg_j, batch, t_max, seed):
    """Random numpy cache leaves: float rows, or int8 rows with positive
    float32 scales."""
    rng = np.random.default_rng(seed)
    shape = (cfg_j.n_layers, batch, t_max, cfg_j.n_kv_heads, cfg_j.head_dim)
    if cfg_j.kv_int8:
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32),
                "vs": rng.uniform(0.002, 0.02, shape[:-1]).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _to_jax(cache, jdt):
    return {n: jnp.asarray(a) if _scale_or_int8(n, a) else jnp.asarray(a, jdt)
            for n, a in cache.items()}


def _to_torch(cache, tdt):
    return {n: torch.from_numpy(a.copy()) if _scale_or_int8(n, a)
            else torch.from_numpy(a).to(tdt) for n, a in cache.items()}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _fills(rung, g_len):
    """Active fills below the rung with room for G new tokens, then one
    inactive row past it (for the top rung: near the end)."""
    w = rung or MAX_LEN
    return np.array([0, 37, w - g_len - 1, min(w + 21, MAX_LEN - g_len)
                     if rung else MAX_LEN - g_len - 3], np.int32)


def _check_logits(name, want, got):
    if name == "f32":
        np.testing.assert_allclose(want, got, atol=1e-4)
        np.testing.assert_array_equal(want.argmax(-1), got.argmax(-1))
        return
    want2 = want.reshape(-1, want.shape[-1])
    got2 = got.reshape(-1, got.shape[-1])
    rel = np.linalg.norm(got2 - want2, axis=-1) \
        / np.linalg.norm(want2, axis=-1)
    assert rel.max() <= BF16_ROW_TOL, rel


def _rel_rows(want, got):
    """Relative L2 error of each (layer, slot, position) row."""
    want = want.reshape(want.shape[0], -1, np.prod(want.shape[2:]))
    got = got.reshape(want.shape)
    return np.linalg.norm(got - want, axis=-1) \
        / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)


def _check_cache(name, jcache, tcache, before, lens, g_len, int8):
    """Written rows (positions lens + g below T) agree; every other row
    is what it was."""
    t_max = before["k"].shape[2]
    written = np.zeros(before["k"].shape[1:3], bool)        # (B, T)
    for b, n in enumerate(lens):
        written[b, n:min(n + g_len, t_max)] = True
    rows = {}
    for leaf in before:
        want, got = _jnp(jcache[leaf]), _np(tcache[leaf])
        old = before[leaf]
        if name == "bf16" and leaf in ("k", "v") and not int8:
            old = np.asarray(jnp.asarray(old, jnp.bfloat16)
                             .astype(jnp.float32))
        np.testing.assert_array_equal(got[:, ~written], old[:, ~written])
        np.testing.assert_array_equal(want[:, ~written], old[:, ~written])
        rows[leaf] = (want[:, written].astype(np.float32),
                      got[:, written].astype(np.float32))
    if name == "bf16":
        # the K/V rows of the second layer inherit the first layer's
        # differently rounded bf16 activations: rows within BF16_ROW_TOL,
        # int8 rows dequantised first
        for leaf in ("k", "v"):
            want, got = rows[leaf]
            if int8:
                scale = rows[leaf + "s"]
                want, got = want * scale[0][..., None], \
                    got * scale[1][..., None]
            assert _rel_rows(want, got).max() <= BF16_ROW_TOL, leaf
        return
    for leaf, (want, got) in rows.items():
        if leaf in ("ks", "vs"):
            np.testing.assert_allclose(got, want, rtol=1e-5)
        elif int8:
            # one quantisation step where a rounding of the row flips
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("rung", RUNGS)
def test_decode_step_window_matches_jax(weights, rung, name, int8):
    jcfg, tcfg = _cfgs(name, int8)
    jp, tp = _params(weights, name)
    cache = _cache(jcfg, 4, MAX_LEN, seed=1)
    lens = _fills(rung, 1)
    token = np.array([3, 77, 150, 9], np.int32)
    jl, jc, jn = jax.jit(lambda p, t, c, n: jax_llama.decode_step(
        p, jcfg, t, c, n, window=rung))(
            jp, jnp.asarray(token), _to_jax(cache, DTYPES[name][0]),
            jnp.asarray(lens))
    tcache = _to_torch(cache, DTYPES[name][1])
    tl, tcache, tn = pt_llama.decode_step(
        tp, tcfg, torch.from_numpy(token).long(), tcache,
        torch.from_numpy(lens), window=rung)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    _check_logits(name, _jnp(jl), tl.numpy())
    _check_cache(name, jc, tcache, cache, lens, 1, int8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("g_len", [2, 5])
@pytest.mark.parametrize("rung", RUNGS)
def test_verify_step_window_matches_jax(weights, rung, g_len, name, int8):
    jcfg, tcfg = _cfgs(name, int8)
    jp, tp = _params(weights, name)
    cache = _cache(jcfg, 4, MAX_LEN, seed=2)
    lens = _fills(rung, g_len)
    tokens = np.random.default_rng(3).integers(0, 256, (4, g_len)) \
        .astype(np.int32)
    jl, jc = jax.jit(lambda p, t, c, n: jax_llama.verify_step(
        p, jcfg, t, c, n, window=rung))(
            jp, jnp.asarray(tokens), _to_jax(cache, DTYPES[name][0]),
            jnp.asarray(lens))
    tcache = _to_torch(cache, DTYPES[name][1])
    tl, tcache = pt_llama.verify_step(
        tp, tcfg, torch.from_numpy(tokens).long(), tcache,
        torch.from_numpy(lens), window=rung)
    _check_logits(name, _jnp(jl), tl.numpy())
    _check_cache(name, jc, tcache, cache, lens, g_len, int8)


@pytest.mark.parametrize("int8", [False, True])
def test_dense_writes_past_the_cache_are_dropped(weights, int8):
    """G 5 at fills 62, 64 and 70 of a 64-position cache (rows whose
    positions run past the end), against JAX ``verify_step``'s
    ``mode="drop"``; then a decode step at fill 64."""
    jcfg, tcfg = _cfgs("f32", int8)
    jp, tp = _params(weights, "f32")
    cache = _cache(jcfg, 4, 64, seed=4)
    lens = np.array([62, 64, 70, 3], np.int32)
    tokens = np.arange(20, dtype=np.int32).reshape(4, 5)
    jl, jc = jax_llama.verify_step(jp, jcfg, jnp.asarray(tokens),
                                   _to_jax(cache, jnp.float32),
                                   jnp.asarray(lens))
    tcache = _to_torch(cache, torch.float32)
    tl, tcache = pt_llama.verify_step(tp, tcfg,
                                      torch.from_numpy(tokens).long(),
                                      tcache, torch.from_numpy(lens))
    _check_logits("f32", np.asarray(jl), tl.numpy())
    _check_cache("f32", jc, tcache, cache, lens, 5, int8)
    lens = np.array([64, 63, 70, 0], np.int32)
    _, jc, _ = jax_llama.decode_step(jp, jcfg, jnp.asarray(tokens[:, 0]),
                                     _to_jax(cache, jnp.float32),
                                     jnp.asarray(lens))
    _, tcache, _ = pt_llama.decode_step(tp, tcfg,
                                        torch.from_numpy(tokens[:, 0]).long(),
                                        _to_torch(cache, torch.float32),
                                        torch.from_numpy(lens))
    _check_cache("f32", jc, tcache, cache, lens, 1, int8)


# -- the identity-table route alone ---------------------------------------------

def _attn_case(name, int8, g_len, rung, seed=5):
    """q (B,G,Hq,D), a dense cache (B,T,Hkv,D) with scale planes under
    int8, new K/V (B,G,Hkv,D), fills with one row past the rung."""
    rng = np.random.default_rng(seed)
    b, t_max, hkv, hq, d = 4, 256, 2, 8, 16
    jcfg = dataclasses.replace(jax_llama.config("tiny"), n_layers=1,
                               n_kv_heads=hkv, n_heads=hq, dim=hq * d,
                               kv_int8=int8)
    cache = {n: a[0] for n, a in _cache(jcfg, b, t_max, seed).items()}
    q = rng.standard_normal((b, g_len, hq, d)).astype(np.float32)
    k_new = rng.standard_normal((b, g_len, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, g_len, hkv, d)).astype(np.float32)
    w = rung or t_max
    lens = np.array([0, 31, w - g_len, w + 9 if rung else t_max - g_len],
                    np.int32)
    return cache, q, k_new, v_new, lens


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("g_len", [1, 5])
@pytest.mark.parametrize("rung", [128, None])
def test_identity_table_route_equals_dense_oracle(rung, g_len, name, int8):
    jdt, tdt = DTYPES[name]
    cache, q, k_new, v_new, lens = _attn_case(name, int8, g_len, rung)
    t_max = cache["k"].shape[1]
    w = rung or t_max
    jc = _to_jax(cache, jdt)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k_new, v_new))
    scales = dict(k_scale=jc["ks"][:, :w], v_scale=jc["vs"][:, :w]) \
        if int8 else {}
    if g_len == 1:
        want = jax_attn.decode_attention_cached(
            jq, jc["k"][:, :w], jc["v"][:, :w], jk[:, 0], jv[:, 0],
            jnp.asarray(lens), **scales)
    else:
        want = jax_attn.verify_attention(
            jq, jc["k"][:, :w], jc["v"][:, :w], jk, jv, jnp.asarray(lens),
            **scales)
    tc = _to_torch(cache, tdt)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k_new, v_new))
    page = pt_llama.dense_page(t_max, rung)
    table = pt_llama.identity_table(4, t_max, rung, device="cpu")
    pools = [tc[n].view(-1, page, *tc[n].shape[2:])
             for n in (("k", "v", "ks", "vs") if int8 else ("k", "v"))]
    tlens = torch.from_numpy(lens)
    if g_len == 1:
        got = ragged_paged_decode_attention(tq, pools[0], pools[1], table,
                                            tk[:, 0], tv[:, 0], tlens,
                                            *pools[2:])
    else:
        got = ragged_paged_verify_attention(tq, pools[0], pools[1], table,
                                            tk, tv, tlens, *pools[2:])
    tol = 1e-5 if name == "f32" else 1.6e-2
    np.testing.assert_allclose(_jnp(want), _np(got), atol=tol, rtol=tol)
    # bit for bit the port's dense oracle over the window's view
    views = {n: tc[n][:, :w] for n in tc}
    oracle = pt_attention.verify_attention(
        tq, views["k"], views["v"], tk, tv, tlens,
        views.get("ks"), views.get("vs"))
    assert torch.equal(got, oracle)


def test_identity_table_layout():
    table = pt_llama.identity_table(3, 512, 128, device="cpu")
    assert table.dtype == torch.int32 and table.is_contiguous()
    assert table.tolist() == [[b * 16 + j for j in range(4)]
                              for b in range(3)]
    assert pt_llama.identity_table(2, 512, None, device="cpu").shape \
        == (2, 16)
    assert [pt_llama.dense_page(t) for t in (2048, 512, 96, 100, 7)] \
        == [32, 32, 32, 4, 1]
    assert pt_llama.dense_page(96, 64) == 32
    assert pt_llama.dense_page(2064) == 16


def test_flash_decode_plain_over_a_window_view():
    rng = np.random.default_rng(6)
    b, t_max, hkv, hq, d = 4, 512, 2, 8, 128
    k, v = (torch.from_numpy(rng.standard_normal((b, t_max, hkv, d))
                             .astype(np.float32)).bfloat16()
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, d))
                         .astype(np.float32)).bfloat16()
    kn, vn = (torch.from_numpy(rng.standard_normal((b, hkv, d))
                               .astype(np.float32)).bfloat16()
              for _ in range(2))
    lens = torch.tensor([0, 100, 255, 300], dtype=torch.int32)
    for w in (128, 256):
        view = decode_mod.flash_decode_attention_plain(
            q, k[:, :w], v[:, :w], kn, vn, lens)
        copy = decode_mod.flash_decode_attention_plain(
            q, k[:, :w].clone(), v[:, :w].clone(), kn, vn, lens)
        assert torch.equal(view, copy)
        assert decode_mod._window_view(k[:, :w])
    assert decode_mod._window_view(k)
    assert not decode_mod._window_view(k.transpose(1, 2))
    assert not decode_mod._window_view(k[:, :, :1])          # one KV head


# -- the engines ---------------------------------------------------------------

# fills: 100 → 149 (alone after the others finish, 128 → 256), 5 → 12,
# 250 → 261 (256 → the whole cache)
PROMPTS = [[(7 * i) % 250 + 1 for i in range(100)], list(range(1, 6)),
           [(3 * i) % 250 + 1 for i in range(250)]]
BUDGETS = [50, 8, 12]
ENGINE_KW = dict(max_slots=4, max_len=MAX_LEN, prompt_buckets=(16, 128, 256))
# γ 1 (verify G 2) keeps the JAX spec engine's compiles to one a rung;
# the steps above hold verify at G 5
SPEC_GAMMA = 1
VARIANTS = {"plain": (False, False), "spec": (False, True),
            "int8": (True, False), "int8_spec": (True, True)}


async def _serve(engine):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, max_new_tokens=n)
              for p, n in zip(PROMPTS, BUDGETS)]), 120.0))
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def jax_dense(weights):
    """The JAX dense engine's concurrent greedy output for each variant
    (steps per tick 4, 2 ticks in flight), computed once; and a JAX engine
    to ask for its window picks."""
    jcfg, _ = _cfgs("f32", False, use_flash=True)
    jdcfg = dataclasses.replace(jcfg, n_layers=1)
    jdraft = jax.tree.map(np.asarray,
                          jax_llama.init(jdcfg, jax.random.PRNGKey(7)))
    out = {}
    for variant, (int8, spec) in VARIANTS.items():
        container = new_mock_container()
        kw = dict(draft_cfg=jdcfg, draft_params=jdraft,
                  spec_gamma=SPEC_GAMMA) if spec else {}
        engine = JaxEngine(dataclasses.replace(jcfg, kv_int8=int8), weights,
                           logger=container.logger,
                           metrics=container.metrics, steps_per_tick=4,
                           **ENGINE_KW, **kw)
        out[variant] = asyncio.run(_serve(engine))
        if spec:
            assert engine.stats()["speculative"]["spec_ticks"] > 0
    out["picker"] = engine
    out["draft"] = from_jax_llama(jdraft, "cpu")
    return out


@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("steps_per_tick", [1, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_engine_greedy_identity_with_jax(weights, jax_dense, variant,
                                               steps_per_tick, inflight):
    int8, spec = VARIANTS[variant]
    _, tcfg = _cfgs("f32", int8, use_flash=True)
    kw = dict(draft_cfg=dataclasses.replace(tcfg, n_layers=1, kv_int8=False),
              draft_params=jax_dense["draft"],
              spec_gamma=SPEC_GAMMA) if spec else {}
    engine = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                              device="cpu", steps_per_tick=steps_per_tick,
                              max_inflight_ticks=inflight, **ENGINE_KW, **kw)
    picks = []
    pick = engine._pick_window

    def recorded(fills, k):
        picks.append((list(fills), k, pick(fills, k)))
        return picks[-1][2]
    engine._pick_window = recorded
    assert asyncio.run(_serve(engine)) == jax_dense[variant]
    stats = engine.stats()
    assert "kv_pool" not in stats and engine.cache is not None
    # every tick's rung is JAX's for the same fills, and the burst's
    # ticks changed rungs (down from the whole cache, then up 128 → 256)
    picker = jax_dense["picker"]
    assert picks and all(picker._pick_window(f, k) == w
                         for f, k, w in picks)
    by_window = stats["ticks_by_window"]
    assert sum(by_window.values()) == stats["ticks"] + (
        stats["speculative"]["spec_ticks"] if spec else 0)
    assert set(by_window) == {128, 256, MAX_LEN}
    if spec:
        assert stats["speculative"]["spec_ticks"] > 0


def test_dense_engine_window_ladder_off_and_paged_engine(weights, jax_dense):
    """``window_ladder=False`` attends the whole cache on every tick; the
    paged engine keeps window None; both serve the same tokens."""
    _, tcfg = _cfgs("f32", False, use_flash=True)
    params = from_jax_llama(weights, "cpu")
    flat = GenerationEngine(tcfg, params, device="cpu", steps_per_tick=4,
                            window_ladder=False, **ENGINE_KW)
    assert asyncio.run(_serve(flat)) == jax_dense["plain"]
    assert flat.stats()["window_ladder"] == [MAX_LEN]
    assert set(flat.stats()["ticks_by_window"]) == {MAX_LEN}
    paged = GenerationEngine(tcfg, params, device="cpu", steps_per_tick=4,
                             paged_kv=True, kv_page=16, **ENGINE_KW)
    assert asyncio.run(_serve(paged)) == jax_dense["plain"]
    assert set(paged.stats()["ticks_by_window"]) == {MAX_LEN}
    assert paged.cache is None and "kv_cache" not in paged.stats()


def test_warmup_windows_and_stats_ladder(weights):
    _, tcfg = _cfgs("f32", True, use_flash=True)
    engine = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                              device="cpu", steps_per_tick=4, **ENGINE_KW)
    warmed = []
    engine._warm = warmed.append

    def rungs(**kw):
        warmed.clear()
        asyncio.run(engine.warmup(**kw))
        return sorted({key[3] or MAX_LEN for key in warmed[0]})

    # the largest bucket (256) + the largest k (4) needs the top rung
    assert rungs() == [128, 256, MAX_LEN]
    assert rungs(windows="all") == [128, 256, MAX_LEN]
    assert rungs(windows=(128, MAX_LEN)) == [128, MAX_LEN]
    assert rungs(windows=(256,), ks=(1,)) == [256]
    assert {key[1] for key in warmed[0]} == {1}
    small = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                             device="cpu", steps_per_tick=2,
                             **dict(ENGINE_KW, prompt_buckets=(16,)))
    small._warm = warmed.append
    warmed.clear()
    asyncio.run(small.warmup())
    assert sorted({key[3] for key in warmed[0]}) == [128]
    for bad in ((64,), (MAX_LEN + 1,), ()):
        with pytest.raises(ValueError, match="window-ladder"):
            asyncio.run(engine.warmup(windows=bad))
    with pytest.raises(ValueError, match="'all'"):
        asyncio.run(engine.warmup(windows="some"))
    # the ladder as JAX prints it, for several max_len
    jcfg, _ = _cfgs("f32", False)
    for max_len in (64, 128, 256, 300, 512):
        kw = dict(max_slots=2, max_len=max_len, prompt_buckets=(16,))
        jax_engine = JaxEngine(jcfg, weights, **kw)
        port = GenerationEngine(tcfg, from_jax_llama(weights, "cpu"),
                                device="cpu", **kw)
        assert port.stats()["window_ladder"] \
            == jax_engine.stats()["window_ladder"], max_len
        assert port.stats()["kv_cache"]["cache_bytes"] == sum(
            leaf.nbytes for leaf in port.cache.values())


def test_cuda_refusals_dense_predicate():
    cfg = pt_llama.config("llama3-8b")
    assert cuda_refusals(cfg, 2048, 32, cfg, 4) == []
    assert cuda_refusals(cfg, 8192, 32) == []
    # view page 16 is held to the gates on the card, 8 is not
    assert cuda_refusals(cfg, 2064, 32) == []
    assert any("dense view page 8" in line
               for line in cuda_refusals(cfg, 2056, 32))
    # the dense engine ignores kv_page; the paged one reads it
    assert cuda_refusals(cfg, 2056, 8, paged_kv=True) == []
    # the top rung's identity table at verify G: 16384 / 32 = 512 columns
    narrow = dataclasses.replace(cfg, n_kv_heads=4)
    refused = cuda_refusals(narrow, 16384, 32, narrow, 4)
    assert any("MAX_DYN_SMEM" in line and "512 columns" in line
               for line in refused), refused
