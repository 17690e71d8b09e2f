"""Port parity: gofr_tpu_torch.ops against gofr_tpu.ops on the same numpy
inputs made from a seed.

Bounds: at float32 ``atol=rtol=1e-5`` (the two frameworks sum in other
orders); at bf16 one bf16 ulp, ``atol=rtol=1.6e-2`` (the two round at
the same points, but an f32 sum-order difference can flip one rounding).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops import norms as jax_norms
from gofr_tpu.ops import rotary as jax_rotary
from gofr_tpu.ops import sampling as jax_sampling
from gofr_tpu_torch.ops import attention as pt_attn
from gofr_tpu_torch.ops import norms as pt_norms
from gofr_tpu_torch.ops import prng as pt_prng
from gofr_tpu_torch.ops import quant as pt_quant
from gofr_tpu_torch.ops import rotary as pt_rotary
from gofr_tpu_torch.ops import sampling as pt_sampling

# the JAX package re-exports ``attention`` the function over the module name
jax_attn = importlib.import_module("gofr_tpu.ops.attention")

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(array, name):
    """The same numpy array as a JAX and a torch tensor of dtype ``name``."""
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(array, dtype=jdt), torch.from_numpy(array).to(tdt)


def _close(jx, tx, name):
    tol = DTYPES[name][2]
    np.testing.assert_allclose(np.asarray(jx, dtype=np.float32),
                               tx.float().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_rms_norm(name):
    rng = _rng()
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _pair(x, name)
    jw, tw = _pair(w, name)
    _close(jax_norms.rms_norm(jx, jw, 1e-5), pt_norms.rms_norm(tx, tw, 1e-5),
           name)


def test_layer_norm():
    rng = _rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 32), (32,), (32,)))
    _close(jax_norms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b)),
           pt_norms.layer_norm(*map(torch.from_numpy, (x, w, b))), "f32")


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_apply_rope(name):
    rng = _rng(2)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 6)).astype(np.int32)
    jcos, jsin = jax_rotary.rope_table(8192, 16, 500000.0)
    tcos, tsin = pt_rotary.rope_table(8192, 16, 500000.0)
    np.testing.assert_allclose(np.asarray(jcos), tcos.numpy(), atol=1e-5)
    jx, tx = _pair(x, name)
    _close(jax_rotary.apply_rope(jx, jcos, jsin, jnp.asarray(pos)),
           pt_rotary.apply_rope(tx, tcos, tsin, torch.from_numpy(pos).long()),
           name)


def test_qmm_plain_and_int8():
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    torch.testing.assert_close(pt_quant.qmm(x, w), x @ w)
    q = torch.from_numpy(rng.integers(-127, 128, (8, 5)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.02, (1, 5)).astype(np.float32))
    torch.testing.assert_close(pt_quant.qmm(x, {"q": q, "s": s}),
                               (x @ q.float()) * s)


def _qkv(rng, b=2, s=16, hq=4, hkv=2, d=16):
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention(name, causal):
    q, k, v = _qkv(_rng(4))
    jq, tq = _pair(q, name)
    jk, tk = _pair(k, name)
    jv, tv = _pair(v, name)
    if causal:
        ref = jax_attn.prefill_attention(jq, jk, jv)
        out = pt_attn.prefill_attention(tq, tk, tv)
    else:
        ref = jax_attn.attention(jq, jk, jv)
        out = pt_attn.attention(tq, tk, tv)
    _close(ref, out, name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_decode_attention_cached(name):
    rng = _rng(5)
    b, t, hq, hkv, d = 4, 24, 4, 2, 16
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((b, hkv, d)).astype(np.float32)
              for _ in range(2))
    lens = np.array([0, 1, 13, 24], np.int32)
    j = [_pair(a, name) for a in (q, kc, vc, kn, vn)]
    ref = jax_attn.decode_attention_cached(*[p[0] for p in j],
                                           jnp.asarray(lens))
    out = pt_attn.decode_attention_cached(*[p[1] for p in j],
                                          torch.from_numpy(lens))
    _close(ref, out, name)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_paged_decode_attention_sentinel_tails(name):
    rng = _rng(6)
    num_pages, page, hq, hkv, d, width = 10, 4, 4, 2, 16, 4
    lens = np.array([0, 3, 4, 9], np.int32)
    table = np.full((4, width), num_pages, np.int32)   # sentinel tails
    nxt = 0
    for row, n in enumerate(lens):
        for col in range(-(-int(n) // page)):
            table[row, col] = nxt
            nxt += 1
    kp, vp = (rng.standard_normal((num_pages, page, hkv, d)).astype(
        np.float32) for _ in range(2))
    q = rng.standard_normal((4, 1, hq, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((4, hkv, d)).astype(np.float32)
              for _ in range(2))
    j = [_pair(a, name) for a in (q, kp, vp)]
    jn = [_pair(a, name) for a in (kn, vn)]
    ref = jax_attn.paged_decode_attention(
        j[0][0], j[1][0], j[2][0], jnp.asarray(table), jn[0][0], jn[1][0],
        jnp.asarray(lens))
    out = pt_attn.paged_decode_attention(
        j[0][1], j[1][1], j[2][1], torch.from_numpy(table), jn[0][1],
        jn[1][1], torch.from_numpy(lens))
    _close(ref, out, name)


def test_gather_kv_pages_clamps_sentinel():
    pages = torch.arange(3 * 2, dtype=torch.float32).reshape(3, 2)
    table = torch.tensor([[0, 3], [2, 1]], dtype=torch.int32)
    out = pt_attn.gather_kv_pages(pages, table)
    assert out.tolist() == [[0, 1, 4, 5], [4, 5, 2, 3]]


def test_filtered_log_probs_batch():
    rng = _rng(7)
    logits = rng.standard_normal((5, 64)).astype(np.float32) * 3
    logits[4, 10] = logits[4, 11]            # a tie, ordered stably
    temps = np.array([1.0, 0.7, 1.3, 0.0, 1.0], np.float32)
    top_k = np.array([0, 5, 0, 3, 10], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.5, 0.9], np.float32)
    ref = jax_sampling.filtered_log_probs_batch(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_k),
        jnp.asarray(top_p))
    out = pt_sampling.filtered_log_probs_batch(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_k).long(), torch.from_numpy(top_p))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-5)
    one = pt_sampling.filtered_log_probs(torch.from_numpy(logits[1]), 0.7,
                                         5, 1.0)
    np.testing.assert_allclose(np.asarray(ref)[1], one.numpy(), atol=1e-5)


def test_sample_batch_greedy_and_seeded_rows():
    rng = _rng(8)
    logits = torch.from_numpy(rng.standard_normal((3, 32)).astype(
        np.float32))
    temps = torch.tensor([0.0, 0.9, 0.0])
    top_k = torch.tensor([0, 4, 4])
    top_p = torch.tensor([1.0, 1.0, 1.0])

    def draw(seed):
        keys = pt_prng.seed_key(torch.tensor([seed] * 3))
        return pt_sampling.sample_batch(logits.clone(), temps, top_k, top_p,
                                        keys)

    (a, a_keys), (b, b_keys) = draw(11), draw(11)
    assert a.tolist() == b.tolist() and torch.equal(a_keys, b_keys)
    assert a[0] == logits[0].argmax() and a[2] == logits[2].argmax()
    assert a[1] in torch.topk(logits[1], 4).indices
    # the key moved on: the next draw splits the carried half
    assert not torch.equal(a_keys, pt_prng.seed_key(torch.tensor([11] * 3)))
