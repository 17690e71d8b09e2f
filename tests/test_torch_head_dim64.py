"""Port parity at head_dim 64, the example app's default preset
(``small``: dim 1024, 16/16 heads), at a narrow size.

- The ragged kernel's plain versions (decode and verify G 3 and 5, bf16
  and int8 pools, GQA groups 1 and 2) against the JAX package's Pallas
  ``ragged_paged_decode_attention`` / ``ragged_paged_verify_attention`` in
  interpret mode (its predicate runs the kernel at head_dim 64 on the
  CPU) and its gather oracle, on fills at page edges with sentinel table
  tails: f32 ``atol=rtol=1e-5``, bf16 one ulp ``1.6e-2``.
- Flash decode's plain version against JAX ``flash_decode_attention``,
  which at head_dim 64 serves its dense oracle (``decode_attention_cached``)
  on every backend: f32 ``2e-5``, bf16 ``1.6e-2``.
- The dense and paged port engines at head_dim 64 (dim 128, 2/2 heads
  and dim 256, 4/2 heads, 2 layers, float32; plain and ``kv_int8``)
  emit the JAX engines' greedy tokens.
- ``cuda_refusals`` takes head_dim 64 (``small`` and its draft, dense and
  paged, its verify width bound computed at 64) and refuses 96.

Each JAX engine runs once per module.
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
from gofr_tpu.ops.pallas import flash_decode_attention as jax_flash
from gofr_tpu.ops.pallas import ragged_paged_decode_attention as jax_decode
from gofr_tpu.ops.pallas import ragged_paged_verify_attention as jax_verify
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.ops.quant import quantize_kv
from gofr_tpu_torch.tpu.generate import GenerationEngine, cuda_refusals

jax_attn = importlib.import_module("gofr_tpu.ops.attention")

D = 64
NUM_PAGES, PAGE, HKV, P = 12, 16, 2, 4
SENTINEL = NUM_PAGES
FILLS = [0, 1, 15, 16, 17, 32, 40]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _ragged_scenario(g_len, group, int8, seed):
    """Pools (float rows, or their int8 quantisation with scale planes),
    a page table covering each fill (pages handed out bottom-up, sentinel
    tails), q (B,G,Hq,D) and the new K/V (B,G,Hkv,D); numpy."""
    rng = np.random.default_rng(seed)
    b = len(FILLS)
    shape = (NUM_PAGES, PAGE, HKV, D)
    pools = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(2)]
    scales = []
    if int8:
        quant = [quantize_kv(torch.from_numpy(x)) for x in pools]
        pools = [q.numpy() for q, _ in quant]
        scales = [s.numpy() for _, s in quant]
    q = rng.standard_normal((b, g_len, HKV * group, D)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((b, g_len, HKV, D))
                    .astype(np.float32) for _ in range(2))
    table = np.full((b, P), SENTINEL, np.int32)
    nxt = 0
    for row, n in enumerate(FILLS):
        for col in range(-(-n // PAGE)):
            table[row, col] = nxt
            nxt += 1
    if g_len == 1:
        k_new, v_new = k_new[:, 0], v_new[:, 0]
    return q, pools, table, k_new, v_new, np.asarray(FILLS, np.int32), scales


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("g_len", [1, 3, 5])
def test_ragged_plain_matches_pallas_at_head_dim_64(name, int8, group,
                                                    g_len):
    jdt, tdt, tol = DTYPES[name]
    q, pools, table, kn, vn, lens, scales = _ragged_scenario(
        g_len, group, int8, seed=7 * g_len + group + 31 * int8)

    def pool_j(x):
        return jnp.asarray(x) if int8 else jnp.asarray(x, jdt)

    def pool_t(x):
        return torch.from_numpy(x) if int8 else torch.from_numpy(x).to(tdt)

    jargs = [jnp.asarray(q, jdt), *map(pool_j, pools), jnp.asarray(table),
             jnp.asarray(kn, jdt), jnp.asarray(vn, jdt), jnp.asarray(lens)]
    targs = [torch.from_numpy(q).to(tdt), *map(pool_t, pools),
             torch.from_numpy(table), torch.from_numpy(kn).to(tdt),
             torch.from_numpy(vn).to(tdt), torch.from_numpy(lens)]
    jscales = {}
    if int8:
        jscales = dict(k_scale_pages=jnp.asarray(scales[0]),
                       v_scale_pages=jnp.asarray(scales[1]))
        targs += [torch.from_numpy(s) for s in scales]
    if g_len == 1:
        kernel, oracle = jax_decode, jax_attn.paged_decode_attention
        port = ragged_mod.ragged_paged_decode_attention
    else:
        kernel, oracle = jax_verify, jax_attn.paged_verify_attention
        port = ragged_mod.ragged_paged_verify_attention
    before = (ragged_mod.launches, ragged_mod.verify_launches,
              ragged_mod.int8_launches, ragged_mod.int8_verify_launches)
    out = port(*targs).float().numpy()          # CPU: the plain version
    assert before == (ragged_mod.launches, ragged_mod.verify_launches,
                      ragged_mod.int8_launches,
                      ragged_mod.int8_verify_launches)
    assert out.shape == q.shape
    for ref in (kernel(*jargs, interpret=True, **jscales),
                oracle(*jargs, **jscales)):
        np.testing.assert_allclose(np.asarray(ref, np.float32), out,
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [(8, 2), (8, 8)])
def test_flash_decode_plain_matches_jax_at_head_dim_64(name, heads):
    jdt, tdt, _ = DTYPES[name]
    tol = 2e-5 if name == "f32" else 1.6e-2
    hq, hkv = heads
    b, t_max = 4, 256
    rng = np.random.default_rng(hq + hkv)
    q = rng.standard_normal((b, 1, hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, t_max, hkv, D)).astype(np.float32)
            for _ in range(2))
    kn, vn = (rng.standard_normal((b, hkv, D)).astype(np.float32)
              for _ in range(2))
    lens = np.asarray([0, 1, 128, 200], np.int32)
    floats = (q, k, v, kn, vn)
    ref = jax_flash(*[jnp.asarray(x, jdt) for x in floats],
                    jnp.asarray(lens), interpret=True)
    out = decode_mod.flash_decode_attention(
        *[torch.from_numpy(x).to(tdt) for x in floats],
        torch.from_numpy(lens))
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               out.float().numpy(), atol=tol, rtol=tol)


# -- the engines --------------------------------------------------------------

GEOMETRIES = {"mha": dict(dim=128, n_heads=2, n_kv_heads=2),
              "gqa": dict(dim=256, n_heads=4, n_kv_heads=2)}
ENGINE_KW = dict(max_slots=4, max_len=256, prompt_buckets=(16, 64),
                 steps_per_tick=4)
PROMPT_LENS = [5, 16, 17, 40, 64]
BUDGETS = [12, 9, 20, 7, 14]


def _cfgs(geometry, int8):
    over = dict(GEOMETRIES[geometry], n_layers=2, ffn_dim=256,
                max_seq_len=256, kv_int8=int8, use_flash=True)
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, **over)
    tcfg = pt_llama.config("tiny", dtype=torch.float32, **over)
    assert jcfg.head_dim == tcfg.head_dim == D
    return jcfg, tcfg


def _prompts(vocab):
    rng = np.random.default_rng(64)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


async def _serve(engine, prompts):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, max_new_tokens=n)
              for p, n in zip(prompts, BUDGETS)]), 120.0))
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def weights():
    return {g: jax.tree.map(np.asarray, jax_llama.init(
        _cfgs(g, False)[0], jax.random.PRNGKey(3))) for g in GEOMETRIES}


@pytest.fixture(scope="module")
def jax_tokens(weights):
    """The JAX engines' greedy tokens: dense for both geometries, int8
    dense and paged (page 16) for MHA, computed once."""
    out = {}
    for geometry, int8, paged in (("mha", False, False),
                                  ("gqa", False, False),
                                  ("mha", True, False),
                                  ("mha", False, True)):
        jcfg, _ = _cfgs(geometry, int8)
        container = new_mock_container()
        kw = dict(paged_kv=True, kv_page=16) if paged else {}
        engine = JaxEngine(jcfg, weights[geometry], logger=container.logger,
                           metrics=container.metrics, **ENGINE_KW, **kw)
        out[geometry, int8, paged] = asyncio.run(
            _serve(engine, _prompts(jcfg.vocab_size)))
    return out


@pytest.mark.parametrize("geometry,int8,paged", [
    ("mha", False, False), ("gqa", False, False), ("mha", True, False),
    ("mha", False, True), ("mha", True, True), ("gqa", False, True)])
def test_engine_greedy_tokens_equal_jax_at_head_dim_64(weights, jax_tokens,
                                                       geometry, int8,
                                                       paged):
    """Dense and paged engines, bf16 and int8 caches or pools; the paged
    engine must emit the dense JAX engine's tokens where JAX ran only the
    dense one (the two JAX layouts agree: the dense row above)."""
    _, tcfg = _cfgs(geometry, int8)
    kw = dict(paged_kv=True, kv_page=16) if paged else {}
    engine = GenerationEngine(tcfg, from_jax_llama(weights[geometry], "cpu"),
                              device="cpu", **ENGINE_KW, **kw)
    want = jax_tokens.get((geometry, int8, paged),
                          jax_tokens.get((geometry, int8, False)))
    assert asyncio.run(_serve(engine, _prompts(tcfg.vocab_size))) == want
    if (geometry, int8) == ("mha", False):
        assert jax_tokens["mha", False, True] == jax_tokens["mha", False,
                                                            False]


def test_cuda_refusals_take_head_dim_64_and_refuse_96():
    small = pt_llama.config("small")
    assert small.head_dim == 64
    assert 64 in ragged_mod.SUPPORTED_HEAD_DIMS
    assert 64 in decode_mod.SUPPORTED_HEAD_DIMS
    draft = dataclasses.replace(small, n_layers=2)
    assert cuda_refusals(small, 1024, 32) == []
    assert cuda_refusals(small, 1024, 32, paged_kv=True) == []
    assert cuda_refusals(small, 1024, 32, draft, 4) == []
    assert cuda_refusals(small, 1024, 32, draft, 4, paged_kv=True) == []
    odd = pt_llama.config("small", dim=1536)          # 16 heads of 96
    assert odd.head_dim == 96
    refused = cuda_refusals(odd, 1024, 32, odd, 4)
    assert sum("head_dim 96" in line for line in refused) == 2, refused
    assert all("(64, 128)" in line for line in refused
               if "head_dim" in line)


def test_verify_width_bound_follows_head_dim():
    """The ragged kernel's shared memory holds the queries and a rank's
    partials at the model's head_dim: at 64 a wider table fits verify G 8
    than at 128, and ``cuda_refusals`` reads the bound at the model's
    head_dim."""
    smem = ragged_mod.dyn_smem_bytes
    group, g_len, page = 8, 8, 32
    widest = {d: max(w for w in range(8, 4096, 8)
                     if smem(w, page, group, g_len, d)
                     <= ragged_mod.MAX_DYN_SMEM) for d in (64, 128)}
    assert widest[64] > widest[128]
    for d in (64, 128):
        heads = dict(n_heads=8 * 2, n_kv_heads=2, dim=16 * d)
        cfg = pt_llama.config("small", **heads)
        assert cfg.head_dim == d
        fits = widest[d] * page
        assert cuda_refusals(cfg, fits, page, cfg, g_len - 1) == []
        over = (widest[d] + 8) * page
        assert any("MAX_DYN_SMEM" in line
                   for line in cuda_refusals(cfg, over, page, cfg, g_len - 1))
