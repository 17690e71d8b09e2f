"""Port parity for dense flash decode attention: the port's
``flash_decode_attention_plain`` against the JAX package's Pallas
``flash_decode_attention`` (interpret mode) and its dense oracle
``decode_attention_cached``.

The shapes tile the Pallas kernel (T % 128 == 0, head_dim 128,
Hq % 8 == 0), so the JAX side really runs its kernel and not its dense
fallback: B 4, T 256, Hq/Hkv 8/2 and 8/8, with fills that include 0, 1,
block boundaries and partial blocks.

Bounds: float32 ``atol=rtol=2e-5`` (the same online softmax summed in
another order; the oracle at f32 rounds nowhere, so it is held to the same
bound); bf16 inputs one output ulp, ``atol=rtol=1.6e-2``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.attention import decode_attention_cached as jax_dense
from gofr_tpu.ops.pallas import flash_decode_attention as jax_flash
from gofr_tpu.ops.pallas.fallback import decode_shapes_tileable
from gofr_tpu_torch.ops.cuda import decode_attention as pt_decode_mod
from gofr_tpu_torch.ops.cuda.decode_attention import (
    flash_decode_attention, flash_decode_attention_plain)

B, T, D = 4, 256, 128
FILL_SETS = {"low": [0, 1, 64, 200], "edges": [128, 255, 37, 130]}
HEADS = {"gqa": (8, 2), "mha": (8, 8)}
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _scenario(fills, hq, hkv, seed=0, poison=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, D)).astype(np.float32)
    if poison:        # every row at or past a slot's fill
        for row, n in enumerate(fills):
            k[row, n:] = np.nan
            v[row, n:] = np.nan
    return q, k, v, k_new, v_new, np.asarray(fills, np.int32)


def _as(args, name):
    jdt, tdt, _ = DTYPES[name]
    *floats, lens = args
    return ([jnp.asarray(a, jdt) for a in floats] + [jnp.asarray(lens)],
            [torch.from_numpy(a).to(tdt) for a in floats]
            + [torch.from_numpy(lens)])


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("fills", sorted(FILL_SETS))
def test_plain_matches_pallas_interpret(fills, heads, name):
    hq, hkv = HEADS[heads]
    assert decode_shapes_tileable(T, 128, D, hq)
    jargs, targs = _as(_scenario(FILL_SETS[fills], hq, hkv), name)
    tol = DTYPES[name][2]
    out = flash_decode_attention_plain(*targs).float().numpy()
    kernel = np.asarray(jax_flash(*jargs, interpret=True), np.float32)
    np.testing.assert_allclose(kernel, out, atol=tol, rtol=tol)
    if name == "f32":
        np.testing.assert_allclose(np.asarray(jax_dense(*jargs)), out,
                                   atol=tol, rtol=tol)


def test_plain_never_reads_rows_past_the_fill():
    fills = FILL_SETS["edges"]
    _, clean = _as(_scenario(fills, 8, 2), "f32")
    _, poisoned = _as(_scenario(fills, 8, 2, poison=True), "f32")
    out = flash_decode_attention_plain(*poisoned)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, flash_decode_attention_plain(*clean),
                               rtol=0, atol=0)


def test_empty_cache_attends_only_the_new_token():
    _, targs = _as(_scenario([0, 0, 0, 0], 8, 2), "f32")
    q, k, v, k_new, v_new, lens = targs
    out = flash_decode_attention_plain(*targs)
    want = v_new.repeat_interleave(4, dim=1)[:, None]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    _, targs = _as(_scenario(FILL_SETS["low"], 8, 2), "bf16")
    before = pt_decode_mod.launches
    torch.testing.assert_close(flash_decode_attention(*targs),
                               flash_decode_attention_plain(*targs),
                               rtol=0, atol=0)
    assert pt_decode_mod.launches == before
