"""Port parity for the Llama model: the JAX package's tiny float32 params
(``llama.init(..., PRNGKey(0))``) go through ``from_jax_llama`` into the
port, and both compute forward logits, bucketed prefill logits and three
paged decode steps (the JAX side with the ragged Pallas kernel in
interpret mode) on the same tokens.

Bound: ``atol=1e-4`` on logits (float32; two layers of matmuls summed in
other orders), ``atol=1e-5`` on the KV pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.models import llama as jax_llama
from gofr_tpu_torch.models import llama as pt_llama
from gofr_tpu_torch.models.convert import from_jax_llama

PAGE, NUM_PAGES, WIDTH = 4, 16, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llama.config("tiny", dtype=jnp.float32)
    jparams = jax_llama.init(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jparams)
    tparams = from_jax_llama(params_np, device="cpu")
    tcfg = pt_llama.config("tiny", dtype=torch.float32)
    return jcfg, jparams, tcfg, tparams


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_from_jax_llama_layout(models):
    _, jparams, tcfg, tparams = models
    assert tparams["layers"]["wq"].shape == (tcfg.n_layers, tcfg.dim,
                                             tcfg.dim)
    np.testing.assert_array_equal(np.asarray(jparams["lm_head"]),
                                  tparams["lm_head"].numpy())


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_logits(models, use_flash):
    jcfg, jparams, tcfg, tparams = models
    tokens = _tokens((2, 12))
    ref = jax_llama.forward(jparams, jcfg, jnp.asarray(tokens))
    cfg = pt_llama.config("tiny", dtype=torch.float32, use_flash=use_flash)
    out = pt_llama.forward(tparams, cfg, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-4)


def _prefill_both(models, tokens, lengths):
    jcfg, jparams, tcfg, tparams = models
    b, s = tokens.shape
    jlogits, jcache, jlen = jax_llama.prefill(
        jparams, jcfg, jnp.asarray(tokens), jax_llama.init_cache(jcfg, b, s),
        lengths=jnp.asarray(lengths))
    tlogits, tcache, tlen = pt_llama.prefill(
        tparams, tcfg, torch.from_numpy(tokens).long(),
        pt_llama.init_cache(tcfg, b, s, device="cpu"),
        lengths=torch.from_numpy(lengths))
    return (jlogits, jcache, jlen), (tlogits, tcache, tlen)


def test_prefill_with_lengths(models):
    tokens = _tokens((3, 8), seed=1)
    lengths = np.array([5, 8, 3], np.int32)
    (jl, jc, jn), (tl, tc, tn) = _prefill_both(models, tokens, lengths)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jc[name]), tc[name].numpy(),
                                   atol=1e-5)


def _with_scratch(leaf):
    """A pool leaf with the port's scratch page row after its pages (the
    sentinel id's row, which dropped writes land in)."""
    return torch.from_numpy(np.concatenate(
        [leaf, np.zeros_like(leaf[:, :1])], axis=1))


def test_decode_step_paged_three_steps(models):
    """Prefill, place the prompt KV in pool pages, then three paged decode
    steps with one inactive row (its append must be dropped)."""
    jcfg, jparams, tcfg, tparams = models
    tokens = _tokens((3, 8), seed=2)
    lengths = np.array([5, 8, 3], np.int32)
    (jl, jc, _), _ = _prefill_both(models, tokens, lengths)
    small = {name: np.asarray(jc[name]) for name in ("k", "v")}
    layers, _, _, hkv, dh = small["k"].shape
    pool = {name: np.zeros((layers, NUM_PAGES, PAGE, hkv, dh), np.float32)
            for name in ("k", "v")}
    table = np.full((3, WIDTH), NUM_PAGES, np.int32)
    nxt = 0
    for row, n in enumerate(lengths):
        for col in range(-(-(int(n) + 3) // PAGE)):    # room for 3 steps
            table[row, col] = nxt
            lo, hi = col * PAGE, min((col + 1) * PAGE, int(n))
            for name in ("k", "v"):
                if hi > lo:
                    pool[name][:, nxt, :hi - lo] = small[name][:, row, lo:hi]
            nxt += 1
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
    np.testing.assert_array_equal(np.asarray(jlen), tlen.numpy())
    for name in ("k", "v"):
        np.testing.assert_allclose(np.asarray(jpool[name]),
                                   tpool[name][:, :NUM_PAGES].numpy(),
                                   atol=1e-5)
    # the inactive row's pages were never written past its prompt
    first = table[2, 0]
    np.testing.assert_array_equal(tpool["k"][:, first, 3:].numpy(), 0.0)
