"""Token sampling: temperature / top-k / top-p, per row (counterpart of
``gofr_tpu/ops/sampling.py``).

Greedy rows (``temperature <= 0``) resolve to ``argmax``. Sampled rows draw
from their own ``torch.Generator`` (one per engine slot, seeded from the
request's seed), so a row's stream depends on its seed alone. The JAX
package draws with threefry keys; those bits are not reproduced here, so
the two agree on the filtered distribution (:func:`filtered_log_probs`),
not on sampled tokens.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# Rows with temperature <= 0 are greedy; this floor only guards the
# division for rows whose sampled branch is discarded anyway.
_TEMP_FLOOR = 1e-6


def filtered_log_probs_batch(logits: torch.Tensor, temperature: torch.Tensor,
                             top_k: torch.Tensor,
                             top_p: torch.Tensor) -> torch.Tensor:
    """Log-probs of the distribution each row samples from, (B, V) f32.

    Descending (stable) sort, temperature scaling with the floor, rank
    based top-k (0 disables), nucleus prefix that always keeps the argmax
    (a token stays while the mass before it is below ``top_p``), then a
    log-softmax scattered back to vocab order. Filtered tokens are -inf.
    ``temperature``/``top_p`` f32 and ``top_k`` int of shape (B,)."""
    vocab = logits.shape[-1]
    sorted_neg, order = torch.sort(-logits, dim=-1, stable=True)
    temp = temperature.float().clamp_min(_TEMP_FLOOR)[:, None]
    scaled = (-sorted_neg).float() / temp
    ranks = torch.arange(vocab, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, top_k, vocab)[:, None]
    keep_k = ranks < k_eff
    probs = torch.softmax(scaled, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep_p = mass_before < top_p.float()[:, None]
    masked = torch.where(keep_k & keep_p, scaled, float("-inf"))
    logp_sorted = torch.log_softmax(masked, dim=-1)
    return torch.zeros_like(logp_sorted).scatter_(-1, order, logp_sorted)


def filtered_log_probs(logits: torch.Tensor, temperature, top_k,
                       top_p) -> torch.Tensor:
    """One row of :func:`filtered_log_probs_batch`: (V,) logits → (V,)."""
    dev = logits.device
    return filtered_log_probs_batch(
        logits[None],
        torch.as_tensor([temperature], dtype=torch.float32, device=dev),
        torch.as_tensor([top_k], dtype=torch.int64, device=dev),
        torch.as_tensor([top_p], dtype=torch.float32, device=dev))[0]


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]]
                 ) -> torch.Tensor:
    """One token per row, (B,) int64.

    Every row starts as ``argmax``. A row with a generator (the caller
    passes one only for sampled rows that take part in this step) draws
    from its filtered distribution with that generator, which advances it
    by one draw."""
    tokens = logits.argmax(dim=-1)
    rows = [i for i, gen in enumerate(generators) if gen is not None]
    if not rows:
        return tokens
    idx = torch.as_tensor(rows, device=logits.device)
    logp = filtered_log_probs_batch(logits[idx], temperature[idx],
                                    top_k[idx], top_p[idx])
    probs = logp.exp()
    for j, row in enumerate(rows):
        tokens[row] = torch.multinomial(probs[j], 1,
                                        generator=generators[row])[0]
    return tokens
