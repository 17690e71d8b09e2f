"""Port parity for weight-only int8 (``ops/quant``), ``sample_logits`` and
``llama.generate`` against the JAX package on the CPU.

- ``quantize`` / ``dequantize`` / ``quantize_tree`` give JAX's bits
  (float32 and bf16 weights, a zero column, exact .5 ties).
- An engine over ``llama.quantize_params`` weights (tiny, float32, dense
  and paged) gives the JAX engine's greedy tokens over JAX's
  ``quantize_params``, and the port's quantisation of the converted
  weights is the conversion of JAX's.
- ``sample_logits`` matches JAX's for the same key: greedy, top-k,
  top-p, over 300 keys, wherever the two best Gumbel scores are more
  than 1e-5 apart (``tests/test_torch_prng.py``).
- ``llama.generate`` matches JAX's, greedy and at a temperature (up to
  those ties).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.container import new_mock_container
from gofr_tpu.models import llama as jax_llama
from gofr_tpu.ops import quant as jax_quant
from gofr_tpu.ops import sampling as jax_sampling
from gofr_tpu.tpu.generate import GenerationEngine as JaxEngine
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops import quant as pt_quant
from gofr_tpu_torch.ops import sampling as pt_sampling
from gofr_tpu_torch.tpu.generate import GenerationEngine

PROMPTS = [[1, 2, 3, 4, 5], list(range(1, 11)), [9, 8, 7], [4] * 13]
BUDGET = 8
ENGINE_KW = dict(max_slots=4, max_len=64, prompt_buckets=(8, 16),
                 steps_per_tick=4)


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_match_jax_bits(dtype):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 48, 40)).astype(np.float32)
    w[:, :, 5] = 0.0                       # a zero column: scale 1
    # exact .5 ties after the scale: amax 127 makes the scale 1
    w[:, 0, 7], w[:, 1, 7], w[:, 2, 7] = 127.0, 2.5, -3.5
    jw = jnp.asarray(w, dtype=getattr(jnp, dtype))
    tw = from_jax_llama({"w": np.asarray(jw)}, "cpu")["w"]
    want = jax_quant.quantize(jw)
    got = pt_quant.quantize(tw)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["q"].dtype == torch.int8 and got["s"].shape == (3, 1, 40)
    np.testing.assert_array_equal(_bits(pt_quant.dequantize(got)),
                                  _jbits(jax_quant.dequantize(want)))
    assert pt_quant.dequantize(tw) is tw


def test_quantize_tree_matches_jax():
    cfg = jax_llama.config("tiny", dtype=jnp.float32)
    jparams = jax_llama.init(cfg, jax.random.PRNGKey(1))
    want = jax.tree.map(np.asarray, jax_llama.quantize_params(jparams))
    got = pt_llama.quantize_params(
        from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu"))
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=str(path))
    # norms and the embedding stay; a tuple/list is walked
    assert not isinstance(got["tok_emb"], dict)
    assert isinstance(got["layers"]["wq"], dict)
    listed = pt_quant.quantize_tree({"wo": [torch.ones(2, 3)],
                                     "w_up": (torch.ones(3),)})
    assert isinstance(listed["wo"], list)
    assert torch.equal(listed["w_up"][0], torch.ones(3))


async def _serve(engine, prompts):
    await engine.start()
    try:
        return list(await asyncio.wait_for(asyncio.gather(
            *[engine.generate(p, BUDGET) for p in prompts]), 60.0))
    finally:
        await engine.stop()


@pytest.mark.parametrize("paged", [False, True])
def test_engine_over_int8_weights_matches_jax(paged):
    jcfg = jax_llama.config("tiny", dtype=jnp.float32, use_flash=True)
    jparams = jax_llama.quantize_params(
        jax_llama.init(jcfg, jax.random.PRNGKey(0)))
    kw = dict(ENGINE_KW, paged_kv=paged, kv_page=4)
    container = new_mock_container()
    want = asyncio.run(_serve(JaxEngine(
        jcfg, jparams, logger=container.logger, metrics=container.metrics,
        **kw), PROMPTS))
    tcfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=True)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    assert tparams["layers"]["wq"]["q"].dtype == torch.int8
    got = asyncio.run(_serve(GenerationEngine(tcfg, tparams, device="cpu",
                                              **kw), PROMPTS))
    assert got == want


def _near_tie(key, scores):
    noisy = prng.gumbel(key.reshape(1, 2), (scores.shape[-1],)) + scores
    top2 = noisy.topk(2, dim=-1).values[0]
    return bool(top2[0] - top2[1] <= 1e-5)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 20, 1.0), (1.3, 0, 0.8),
    (0.9, 50, 0.9)])
def test_sample_logits_matches_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    keys = rng.integers(0, 2 ** 32, (300, 2), dtype=np.uint64).astype(
        np.uint32)
    logits = (rng.standard_normal((300, 256)) * 3).astype(np.float32)
    agree, ties = [], 0
    for row, key in zip(logits, keys):
        want = int(jax_sampling.sample_logits(
            jnp.asarray(row), jnp.float32(temperature), jnp.int32(top_k),
            jnp.float32(top_p), jnp.asarray(key)))
        tkey = torch.from_numpy(key.astype(np.int64))
        got = int(pt_sampling.sample_logits(torch.from_numpy(row),
                                            temperature, top_k, top_p, tkey))
        if got != want:
            _, masked = pt_sampling._sorted_masked(
                torch.from_numpy(row)[None],
                torch.tensor([temperature]), torch.tensor([top_k]),
                torch.tensor([top_p]))
            assert _near_tie(tkey, masked), (got, want)
            ties += 1
        agree.append(got == want)
    assert np.mean(agree) >= 0.99
    if temperature == 0.0:
        assert all(agree)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_jax(temperature):
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (3, 9)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_llama.generate(
        jparams, jcfg, jnp.asarray(tokens), 12, temperature=temperature,
        rng=key))
    tcfg = pt_llama.config("tiny", dtype=torch.float32)
    tparams = from_jax_llama(jax.tree.map(np.asarray, jparams), "cpu")
    got = pt_llama.generate(
        tparams, tcfg, torch.from_numpy(tokens).long(), 12,
        temperature=temperature,
        rng=torch.from_numpy(np.asarray(key).astype(np.int64))).numpy()
    assert got.shape == want.shape == (3, 12) and got.dtype == np.int32
    if temperature == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        # up to a Gumbel near-tie (then the rest of the row follows it)
        for g_row, w_row in zip(got, want):
            differ = np.nonzero(g_row != w_row)[0]
            assert differ.size == 0 or differ[0] > 0
        assert (got == want).mean() >= 0.9
    # rng None is PRNGKey(0)
    default = pt_llama.generate(tparams, tcfg, torch.from_numpy(tokens).long(),
                                3).numpy()
    np.testing.assert_array_equal(default, np.asarray(jax_llama.generate(
        jparams, jcfg, jnp.asarray(tokens), 3)))
