"""Threefry-2x32 counter-based random numbers in torch (counterpart of the
parts of ``jax.random`` the JAX package's sampler uses, in its
configuration: ``jax_threefry_partitionable`` True, the default of jax
0.9, and the "low" Gumbel mode).

A key is a pair of 32-bit words. Torch's ``uint32`` lacks most arithmetic,
so every word lives in an int64 tensor, kept in ``[0, 2**32)`` by masking
after each addition and shift: a key array is int64 ``(..., 2)``. Every
function here is a fixed sequence of tensor ops on the key's device: no
host read, no Python loop over rows, so it runs inside a captured CUDA
graph, and a batch of keys goes through at once.

- :func:`seed_key`: ``jax.random.PRNGKey(seed)`` of a 32-bit seed.
- :func:`split`: ``jax.random.split(key, n)`` (fold-like: word pair
  ``threefry(key, (0, i))`` for child ``i``).
- :func:`random_bits`: ``jax.random.bits(key, shape)``, 32-bit words
  ``hi ^ lo`` of ``threefry(key, (0, flat index))``.
- :func:`uniform`: ``jax.random.uniform`` in float32 (the top 23 bits as
  a mantissa in [1, 2), minus one, scaled and shifted as one fused
  multiply-add, floored at ``minval``).
- :func:`categorical`: ``jax.random.categorical`` by the Gumbel-max trick
  over the last axis.

Integer results are bit-identical to ``jax.random``'s. A Gumbel score
goes through two logarithms, whose last bit may differ between torch and
XLA, so a categorical draw can differ where two scores tie within that.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT_ONE_BITS = 0x3F800000          # 1.0f
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block cipher, 20 rounds, on int64 tensors holding
    32-bit words (broadcast together). Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def seed_key(seed: torch.Tensor) -> torch.Tensor:
    """Keys of 32-bit seeds (any integer tensor, values taken mod 2**32):
    ``(..., 2)`` int64 ``(0, seed)``, as ``jax.random.PRNGKey`` makes
    them from a uint32 seed."""
    low = seed.long() & MASK
    return torch.stack([torch.zeros_like(low), low], dim=-1)


def _counters(shape: Sequence[int], device) -> torch.Tensor:
    n = 1
    for dim in shape:
        n *= int(dim)
    return torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))


def _hash(keys: torch.Tensor, shape: Sequence[int]):
    """threefry(key, (0, i)) for every flat index ``i`` of ``shape``, for
    each key of ``keys`` (..., 2): two words of shape (..., *shape)."""
    lo = _counters(shape, keys.device)
    pad = (slice(None),) * (keys.dim() - 1) + (None,) * len(shape)
    k0, k1 = keys[..., 0][pad], keys[..., 1][pad]
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``n`` child keys of each key: (..., 2) -> (..., n, 2)."""
    y0, y1 = _hash(keys, (n,))
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key: (..., 2) ->
    int64 (..., *shape) in [0, 2**32)."""
    y0, y1 = _hash(keys, shape)
    return y0 ^ y1


def uniform(keys: torch.Tensor, shape: Sequence[int],
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform on [minval, maxval) for each key: (..., 2) ->
    (..., *shape)."""
    bits = (random_bits(keys, shape) >> 9) | _FLOAT_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(np.float32(maxval) - np.float32(minval)))
    # XLA contracts the scale and shift into one fused multiply-add: a
    # float64 product (exact) and sum, rounded once to float32, give its
    # bits
    return (floats.double() * scale + lo).float().clamp_min(lo)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard Gumbel noise for each key (the "low" mode)."""
    return -torch.log(-torch.log(uniform(keys, shape, minval=_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (..., V) from ``softmax(logits)``,
    row ``r`` with key ``keys[r]`` (..., 2): ``argmax(gumbel + logits)``.
    Returns int64 (...)."""
    noise = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(noise + logits.float(), dim=-1)
