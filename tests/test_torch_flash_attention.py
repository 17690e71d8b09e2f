"""Port parity for the flash prefill kernel's plain version:
``flash_attention_plain`` (and the wrapper, which takes it for CPU
tensors) against the JAX package's Pallas ``flash_attention`` run in
interpret mode, at the geometry of tests/test_pallas.py.

Bound: ``atol=1e-5`` at float32 (sum order; the Pallas kernel's online
softmax against the plain version's two-pass one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.pallas import flash_attention as jax_flash
from gofr_tpu_torch.ops.cuda import flash_attention as pt_flash_mod
from gofr_tpu_torch.ops.cuda.flash_attention import (flash_attention,
                                                     flash_attention_plain)


def _qkv(seq=256, q_heads=4, kv_heads=2, dim=128, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, seq, q_heads, dim)).astype(np.float32),
            rng.standard_normal((batch, seq, kv_heads, dim)).astype(
                np.float32),
            rng.standard_normal((batch, seq, kv_heads, dim)).astype(
                np.float32))


@pytest.mark.parametrize("kv_heads", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret(kv_heads, causal):
    q, k, v = _qkv(kv_heads=kv_heads)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, interpret=True, block_q=128, block_k=128)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-5)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = pt_flash_mod.launches
    torch.testing.assert_close(flash_attention(tq, tk, tv, causal=causal),
                               out, rtol=0, atol=0)
    assert pt_flash_mod.launches == before


def test_plain_short_prompt_matches_jax_fallback():
    """A 5-token, head_dim-16 prompt: JAX takes its dense fallback, the
    port's plain version is the same math."""
    q, k, v = _qkv(seq=5, dim=16, seed=1)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), atol=1e-5)
