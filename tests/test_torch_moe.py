"""Port parity for the MoE model module (``models/moe``) and the engine
serving it (``model_module=moe``) against the JAX package on the CPU, at
float32.

- ``forward`` logits and aux loss, ``prefill`` (right-padded rows) and
  ``decode_step(window=)`` equal JAX's within float32 rounding, on MoE
  ``tiny`` (4 experts) and a narrow 2-layer ``small`` (8 experts), on an
  input whose capacity overflows (the test counts the kept tokens).
- The port's engine with ``model_module=moe`` gives the JAX engine's
  tokens (JAX's ``moe`` module): eight requests of mixed lengths over
  three buckets, greedy and sampled, one constrained (biased prefill and
  ``bias`` ticks), dense with the window ladder, 8 slots, so capacity
  binds in ticks and prefills. Its views take the MoE config.
- JAX's refusals for a module other than llama, with JAX's messages:
  ``paged_kv``, ``prefix_cache``, a draft, ``mesh``; and ``kv_int8`` at
  the first prefill.
"""

import asyncio
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.models import moe as jax_moe
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu.tpu.generate import Sampling as JaxSampling
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models import moe as pt_moe
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.tpu.generate import (GenerationEngine, Sampling,
                                         cuda_refusals)

NARROW = dict(vocab_size=512, dim=128, n_layers=2, n_heads=2, n_kv_heads=2,
              ffn_dim=256, max_seq_len=128)
PROMPTS = [[3, 1, 4], [1, 5, 9, 2, 6, 5, 3], [5] * 12, [8, 9, 7, 9],
           list(range(40, 56)), [2, 7, 1, 8, 2, 8, 1, 8, 2], [6],
           list(range(100, 130))]
BUDGET = 10
ENGINE_KW = dict(max_slots=8, max_len=256, prompt_buckets=(8, 16, 32),
                 steps_per_tick=4)
REGEX = {"type": "regex", "pattern": "(ab|cd)+!"}


def _configs(name):
    if name == "tiny":
        return (jax_moe.config("tiny", base=jax_llama.config(
                    "tiny", dtype=jnp.float32)),
                pt_moe.config("tiny", base=pt_llama.config(
                    "tiny", dtype=torch.float32)))
    return (jax_moe.config("small", base=jax_llama.config(
                "small", dtype=jnp.float32, **NARROW)),
            pt_moe.config("small", base=pt_llama.config(
                "small", dtype=torch.float32, **NARROW)))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in ("tiny", "small"):
        jcfg, pcfg = _configs(name)
        jparams = jax_moe.init(jcfg, jax.random.PRNGKey(0))
        out[name] = (jcfg, pcfg, jparams,
                     from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu"))
    return out


def _tokens(cfg, seed, shape=(3, 16)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, shape)
    tokens[1] = tokens[1, 0]          # one row a single repeated token
    return tokens


def test_config_delegates_to_its_base():
    _, pcfg = _configs("small")
    assert pcfg.n_experts == 8 and pcfg.capacity_factor == 1.25
    for name in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                 "head_dim", "max_seq_len", "dtype", "kv_int8"):
        assert getattr(pcfg, name) == getattr(pcfg.base, name)
    assert pt_moe.PRESETS["small"].base == pt_llama.PRESETS["small"]
    assert pt_moe.config("tiny", n_experts=2).n_experts == 2
    params = pt_moe.init(pt_moe.config("tiny"), 3, device="cpu")
    layers = params["layers"]
    assert layers["router"].dtype == torch.float32
    assert layers["router"].shape == (2, 64, 4)
    assert layers["w_gate"].shape == (2, 4, 64, 128)
    assert layers["w_down"].shape == (2, 4, 128, 64)


@pytest.mark.parametrize("name", ["tiny", "small"])
def test_forward_matches_jax_and_capacity_overflows(models, name,
                                                    monkeypatch):
    jcfg, pcfg, jparams, pparams = models[name]
    tokens = _tokens(pcfg, 1)
    want, want_aux = jax_moe.forward(jparams, jcfg, jnp.asarray(tokens))
    kept = []
    ffn = pt_moe._moe_ffn

    def counted(layer, x, cfg, drops=None):
        # the port's routing, counted: tokens whose expert has room
        flat = x.reshape(-1, x.shape[-1]).float()
        idx = (flat @ layer["router"]).softmax(-1).argmax(-1)
        counts = torch.bincount(idx, minlength=cfg.n_experts)
        cap = max(1, math.ceil(flat.shape[0] / cfg.n_experts
                               * cfg.capacity_factor))
        kept.append((int(counts.clamp(max=cap).sum()), flat.shape[0]))
        return ffn(layer, x, cfg, drops)
    monkeypatch.setattr(pt_moe, "_moe_ffn", counted)
    got, aux = pt_moe.forward(pparams, pcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    assert abs(float(aux) - float(want_aux)) < 1e-6
    assert len(kept) == pcfg.n_layers
    assert any(k < t for k, t in kept), kept     # capacity overflowed


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("name", ["tiny", "small"])
def test_prefill_and_decode_step_match_jax(models, name, window):
    jcfg, pcfg, jparams, pparams = models[name]
    tokens = _tokens(pcfg, 2)
    lens = np.array([16, 5, 9])
    jcache = jax_moe.init_cache(jcfg, 3, 64)
    pcache = pt_moe.init_cache(pcfg, 3, 64, device="cpu")
    jlog, jcache, jlen = jax_moe.prefill(jparams, jcfg, jnp.asarray(tokens),
                                         jcache, jnp.asarray(lens))
    plog, pcache, plen = pt_moe.prefill(pparams, pcfg,
                                        torch.from_numpy(tokens), pcache,
                                        torch.from_numpy(lens))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(pcache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), atol=2e-5)
    token = np.asarray(jlog).argmax(-1)
    for _ in range(3):
        jlog, jcache, jlen = jax_moe.decode_step(
            jparams, jcfg, jnp.asarray(token), jcache, jlen, window=window)
        plog, pcache, plen = pt_moe.decode_step(
            pparams, pcfg, torch.from_numpy(token), pcache, plen,
            window=window)
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog),
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))
        token = np.asarray(jlog).argmax(-1)


async def _serve(engine, sampling, constrained=True):
    async def one(i, prompt):
        kw = {}
        if i == 3:
            kw["sampling"] = sampling(0.8, seed=7)
        if i == 5 and constrained:
            kw["response_format"] = REGEX
        return await engine.generate(prompt, BUDGET, **kw)
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[one(i, p) for i, p in enumerate(PROMPTS)]), 120.0))
    finally:
        await engine.stop()


@pytest.fixture(scope="module")
def jax_tokens(models):
    jcfg, _, jparams, _ = models["tiny"]
    container = new_mock_container()
    engine = JaxEngine(jcfg, jparams, model_module=jax_moe,
                       logger=container.logger, metrics=container.metrics,
                       **ENGINE_KW)
    return asyncio.run(_serve(engine, JaxSampling))


def test_moe_engine_matches_jax(models, jax_tokens):
    _, pcfg, _, pparams = models["tiny"]
    engine = GenerationEngine(pcfg, pparams, model_module=pt_moe,
                              device="cpu", **ENGINE_KW)
    got = asyncio.run(_serve(engine, Sampling))
    assert got == jax_tokens
    stats = engine.stats()
    # the constrained request took a biased prefill and bias ticks; the
    # eight requests were admitted together (capacity over every row)
    assert stats["constrained"]["ticks"] > 0
    assert stats["prefill_dispatches"] == 4      # the biased group apart
    assert 128 in stats["ticks_by_window"]
    for view in (engine.statusz(), engine.xlaz(), engine.hbm_attribution(),
                 engine.health_check()):
        json.dumps(view, default=str)
    assert engine.hbm_attribution()["params_bytes"] == sum(
        t.numel() * t.element_size()
        for t in jax.tree_util.tree_leaves(pparams))


def test_moe_engine_steps_and_prefill_rows(models):
    """The MoE engine's ticks and prefills run through the module (8
    slots, every one routed), and a group's rows are the count ladder's
    rung, as JAX's."""
    _, pcfg, _, pparams = models["tiny"]
    engine = GenerationEngine(pcfg, pparams, model_module=pt_moe,
                              device="cpu", **ENGINE_KW)
    calls = []
    prefill = pt_moe.prefill

    def spy(params, cfg, tokens, cache, lengths=None):
        calls.append(tuple(tokens.shape))
        return prefill(params, cfg, tokens, cache, lengths)
    pt_moe.prefill = spy
    try:
        asyncio.run(_serve(engine, Sampling, constrained=False))
    finally:
        pt_moe.prefill = prefill
    assert sorted(calls) == [(1, 32), (4, 8), (4, 16)]
    assert engine._prefill_count(1, 32) == 1


def test_cuda_refusals_take_an_moe_config():
    cfg = pt_moe.config(base=pt_llama.config("small", vocab_size=256))
    assert cuda_refusals(cfg, 1024, 32) == []


REFUSALS = {
    "paged_kv": dict(paged_kv=True),
    "prefix_cache": dict(prefix_cache=True),
    "draft": "draft",
    "mesh": "mesh",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_moe_engine_refuses_as_jax(models, case):
    jcfg, pcfg, jparams, pparams = models["tiny"]
    kw = REFUSALS[case]
    jkw = pkw = kw
    if kw == "draft":
        jkw = dict(draft_cfg=jcfg, draft_params=jparams)
        pkw = dict(draft_cfg=pcfg, draft_params=pparams)
    elif kw == "mesh":
        jkw = pkw = dict(mesh=object())
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg, jparams, model_module=jax_moe, **ENGINE_KW, **jkw)
    with pytest.raises(ValueError) as got:
        GenerationEngine(pcfg, pparams, model_module=pt_moe, device="cpu",
                         **ENGINE_KW, **pkw)
    assert str(got.value) == str(want.value)


def test_moe_engine_lacking_entry_points_is_refused(models):
    _, pcfg, _, pparams = models["tiny"]

    class Partial:
        init_cache = staticmethod(pt_moe.init_cache)

    with pytest.raises(ValueError, match=r"lacks serving entry points "
                                         r"\['prefill', 'decode_step'\]"):
        GenerationEngine(pcfg, pparams, model_module=Partial, device="cpu")


def test_moe_kv_int8_is_refused_at_the_first_prefill(models):
    _, pcfg, _, pparams = models["tiny"]
    cfg = pt_moe.config("tiny", base=pt_llama.config(
        "tiny", dtype=torch.float32, kv_int8=True))
    engine = GenerationEngine(cfg, pparams, model_module=pt_moe,
                              device="cpu", **ENGINE_KW)

    async def run():
        await engine.start()
        try:
            with pytest.raises(ValueError,
                               match=r"MoE serving path is bf16-only "
                                     r"\(kv_int8=False\)"):
                await asyncio.wait_for(engine.generate([1, 2, 3], 4), 30)
        finally:
            await engine.stop()
    asyncio.run(run())
    with pytest.raises(ValueError, match="bf16-only"):
        pt_moe.prefill(pparams, cfg, torch.zeros((1, 4), dtype=torch.long),
                       pt_moe.init_cache(cfg, 1, 8, device="cpu"))
