"""Port parity for the ragged paged decode kernel's plain version:
``ragged_paged_decode_attention_plain`` against the JAX package's Pallas
``ragged_paged_decode_attention`` (interpret mode) and its gather oracle
``paged_decode_attention``, on fills that include 0, exact page boundaries
and partial pages, with sentinel table tails.

Pages no live position references are poisoned with NaN: the port's
plain version must stay finite (it clamps sentinels and zeroes V rows
past the fill) and agree with the JAX kernel, which never reads them.

Bounds as in test_torch_ops: f32 ``atol=rtol=1e-5``; bf16 one ulp,
``atol=rtol=1.6e-2``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.pallas import ragged_paged_decode_attention as jax_ragged
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as pt_ragged_mod
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention, ragged_paged_decode_attention_plain)

jax_attn = importlib.import_module("gofr_tpu.ops.attention")

NUM_PAGES, PAGE, HKV, HQ, D, P = 12, 16, 2, 4, 16, 4
SENTINEL = NUM_PAGES
FILLS = [0, 1, 15, 16, 17, 32, 40]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _scenario(fills, poison: bool, poison_tails: bool = False, seed=0):
    """Numpy pools, queries, new K/V and a page table covering each fill
    (pages handed out bottom-up, sentinel tails). With ``poison`` every
    page no live position references is NaN; ``poison_tails`` also NaNs
    the dead rows of each partly filled page (the JAX kernel reads those
    rows and masks only their scores, so only the port is held to it)."""
    rng = np.random.default_rng(seed)
    b = len(fills)
    shape = (NUM_PAGES, PAGE, HKV, D)
    k_pages = rng.standard_normal(shape).astype(np.float32)
    v_pages = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((b, 1, HQ, D)).astype(np.float32)
    k_new = rng.standard_normal((b, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((b, HKV, D)).astype(np.float32)
    table = np.full((b, P), SENTINEL, np.int32)
    used = set()
    nxt = 0
    for row, n in enumerate(fills):
        for col in range(-(-n // PAGE)):
            table[row, col] = nxt
            used.add(nxt)
            nxt += 1
    assert nxt < NUM_PAGES
    if poison:
        for pid in set(range(NUM_PAGES)) - used:
            k_pages[pid] = np.nan
            v_pages[pid] = np.nan
    if poison_tails:
        for row, n in enumerate(fills):
            if n % PAGE:
                k_pages[table[row, n // PAGE], n % PAGE:] = np.nan
                v_pages[table[row, n // PAGE], n % PAGE:] = np.nan
    return q, k_pages, v_pages, table, k_new, v_new, np.asarray(fills,
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
def test_plain_matches_pallas_interpret_and_gather_oracle(name):
    jargs, targs = _as(_scenario(FILLS, poison=False), name)
    tol = DTYPES[name][2]
    out = ragged_paged_decode_attention_plain(*targs).float().numpy()
    kernel = jax_ragged(*jargs, interpret=True)
    oracle = jax_attn.paged_decode_attention(*jargs)
    for ref in (kernel, oracle):
        np.testing.assert_allclose(np.asarray(ref, np.float32), out,
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_never_reads_poisoned_pages(name):
    clean_j, clean_t = _as(_scenario(FILLS, poison=False), name)
    pois_j, pois_t = _as(_scenario(FILLS, poison=True), name)
    tol = DTYPES[name][2]
    out = ragged_paged_decode_attention_plain(*pois_t).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(
        out, ragged_paged_decode_attention_plain(*clean_t).float().numpy())
    kernel = np.asarray(jax_ragged(*pois_j, interpret=True), np.float32)
    assert np.isfinite(kernel).all()
    np.testing.assert_allclose(kernel, out, atol=tol, rtol=tol)
    _, tails_t = _as(_scenario(FILLS, poison=True, poison_tails=True), name)
    np.testing.assert_array_equal(
        out, ragged_paged_decode_attention_plain(*tails_t).float().numpy())


def test_wrapper_on_cpu_is_the_plain_version():
    _, targs = _as(_scenario(FILLS, poison=True), "bf16")
    before = pt_ragged_mod.launches
    torch.testing.assert_close(ragged_paged_decode_attention(*targs),
                               ragged_paged_decode_attention_plain(*targs),
                               rtol=0, atol=0)
    assert pt_ragged_mod.launches == before
