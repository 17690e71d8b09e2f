"""Port parity for speculative verify attention: the port's
``ragged_paged_verify_attention`` (a CPU tensor runs its plain version)
and ``paged_verify_attention`` against the JAX package's Pallas
``ragged_paged_verify_attention`` (interpret mode) and its gather oracle
``paged_verify_attention``, for G in {1, 2, 3, 5} new tokens, on fills
that include 0, exact page boundaries and partial pages, with sentinel
table tails.

Pages no live position references are poisoned with NaN: the port's
plain version must stay finite and unchanged, and agree with the JAX
kernel, which never reads them. G = 1 verify must equal the port's
decode plain version bit for bit.

Bounds as in test_torch_ops: f32 ``atol=rtol=1e-5``; bf16 one ulp,
``atol=rtol=1.6e-2``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.pallas import ragged_paged_verify_attention as jax_verify
from gofr_tpu_torch.ops import attention as pt_attention
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as pt_ragged_mod
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention_plain, ragged_paged_verify_attention,
    ragged_paged_verify_attention_plain)

jax_attn = importlib.import_module("gofr_tpu.ops.attention")

NUM_PAGES, PAGE, HKV, HQ, D, P = 12, 16, 2, 4, 16, 4
SENTINEL = NUM_PAGES
FILLS = [0, 1, 15, 16, 17, 32, 40]
G_LENS = [1, 2, 3, 5]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _scenario(g_len, poison: bool, seed=0):
    """Numpy pools, G queries and new K/V per slot, and a page table
    covering each fill (pages handed out bottom-up, sentinel tails). With
    ``poison`` every page no live position references is NaN."""
    rng = np.random.default_rng(seed)
    b = len(FILLS)
    shape = (NUM_PAGES, PAGE, HKV, D)
    k_pages = rng.standard_normal(shape).astype(np.float32)
    v_pages = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((b, g_len, HQ, D)).astype(np.float32)
    k_new = rng.standard_normal((b, g_len, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((b, g_len, HKV, D)).astype(np.float32)
    table = np.full((b, P), SENTINEL, np.int32)
    used = set()
    nxt = 0
    for row, n in enumerate(FILLS):
        for col in range(-(-n // PAGE)):
            table[row, col] = nxt
            used.add(nxt)
            nxt += 1
    if poison:
        for pid in set(range(NUM_PAGES)) - used:
            k_pages[pid] = np.nan
            v_pages[pid] = np.nan
    return q, k_pages, v_pages, table, k_new, v_new, np.asarray(FILLS,
                                                                np.int32)


def _as(args, name):
    jdt, tdt, _ = DTYPES[name]
    q, kp, vp, table, kn, vn, lens = args
    jargs = [jnp.asarray(a, jdt) for a in (q, kp, vp)] + [jnp.asarray(table)] \
        + [jnp.asarray(a, jdt) for a in (kn, vn)] + [jnp.asarray(lens)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, kp, vp)] \
        + [torch.from_numpy(table)] \
        + [torch.from_numpy(a).to(tdt) for a in (kn, vn)] \
        + [torch.from_numpy(lens)]
    return jargs, targs


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("g_len", G_LENS)
def test_verify_matches_pallas_interpret_and_gather_oracle(g_len, name):
    jargs, targs = _as(_scenario(g_len, poison=False), name)
    tol = DTYPES[name][2]
    out = ragged_paged_verify_attention(*targs).float().numpy()
    assert out.shape == (len(FILLS), g_len, HQ, D)
    np.testing.assert_array_equal(
        pt_attention.paged_verify_attention(*targs).float().numpy(), out)
    kernel = jax_verify(*jargs, interpret=True)
    oracle = jax_attn.paged_verify_attention(*jargs)
    for ref in (kernel, oracle):
        np.testing.assert_allclose(np.asarray(ref, np.float32), out,
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("g_len", [2, 5])
def test_verify_plain_never_reads_poisoned_pages(g_len, name):
    _, clean_t = _as(_scenario(g_len, poison=False), name)
    pois_j, pois_t = _as(_scenario(g_len, poison=True), name)
    tol = DTYPES[name][2]
    out = ragged_paged_verify_attention_plain(*pois_t).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, ragged_paged_verify_attention_plain(*clean_t).float().numpy())
    kernel = np.asarray(jax_verify(*pois_j, interpret=True), np.float32)
    assert np.isfinite(kernel).all()
    np.testing.assert_allclose(kernel, out, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_g1_verify_is_bitwise_the_decode_plain_version(name):
    _, targs = _as(_scenario(1, poison=True), name)
    q, kp, vp, table, kn, vn, lens = targs
    verify = ragged_paged_verify_attention_plain(*targs)
    decode = ragged_paged_decode_attention_plain(q, kp, vp, table, kn[:, 0],
                                                 vn[:, 0], lens)
    torch.testing.assert_close(verify, decode, rtol=0, atol=0)


def test_causal_mask_among_new_tokens():
    """Query g must not see new key u > g: changing the last new token's
    K/V leaves every earlier query's output unchanged."""
    _, targs = _as(_scenario(3, poison=False), "f32")
    q, kp, vp, table, kn, vn, lens = targs
    base = ragged_paged_verify_attention(*targs)
    kn2, vn2 = kn.clone(), vn.clone()
    kn2[:, 2] += 3.0
    vn2[:, 2] -= 5.0
    moved = ragged_paged_verify_attention(q, kp, vp, table, kn2, vn2, lens)
    torch.testing.assert_close(moved[:, :2], base[:, :2], rtol=0, atol=0)
    assert not torch.equal(moved[:, 2], base[:, 2])


def test_verify_wrapper_on_cpu_is_the_plain_version():
    _, targs = _as(_scenario(3, poison=True), "bf16")
    before = pt_ragged_mod.verify_launches
    torch.testing.assert_close(ragged_paged_verify_attention(*targs),
                               ragged_paged_verify_attention_plain(*targs),
                               rtol=0, atol=0)
    assert pt_ragged_mod.verify_launches == before


def test_verify_form_entry_refuses_cpu_tensors():
    """The kernel's verify-instantiation entry has no plain version: it
    exists to hold that instantiation against the decode one on the card."""
    _, targs = _as(_scenario(1, poison=False), "bf16")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pt_ragged_mod.ragged_paged_verify_form_attention(*targs)
