"""Token sampling: temperature / top-k / top-p, per row, and speculative
draft-verify acceptance (counterpart of ``gofr_tpu/ops/sampling.py``).

Greedy rows (``temperature <= 0``) resolve to ``argmax``. Sampled rows
draw with their own threefry key (``ops/prng``, the JAX package's
generator and configuration): each engine slot holds a key made from its
request's seed, and every draw splits it the way the JAX package does, so
a slot's stream is a function of its seed alone, whatever the batching.
Both branches are computed for every row and one is kept per row, as the
JAX package does inside one program: there is no host read, no Python
loop over rows and no ``torch.Generator``, so a captured CUDA graph runs
the sampler. Draws are bit-identical to JAX's up to the last bit of the
Gumbel scores' logarithms (``ops/prng``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gofr_tpu_torch.ops import prng

# Rows with temperature <= 0 are greedy; this floor only guards the
# division for rows whose sampled branch is discarded anyway.
_TEMP_FLOOR = 1e-6
# Residual distributions with less mass than this fall back to the plain
# target distribution (the residual is numerically all-zero only when
# draft and target agree almost exactly, where the fallback is harmless).
_RESIDUAL_FLOOR = 1e-9


def _sorted_masked(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, masked): the descending (stable) sort order of each row and
    its temperature-scaled logits in that order, with the top-k (rank
    based, 0 disables) and nucleus (a token stays while the mass before
    it is below ``top_p``, so the argmax always stays) filters set to
    -inf."""
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
    return order, torch.where(keep_k & keep_p, scaled, float("-inf"))


def filtered_log_probs_batch(logits: torch.Tensor, temperature: torch.Tensor,
                             top_k: torch.Tensor,
                             top_p: torch.Tensor) -> torch.Tensor:
    """Log-probs of the distribution each row samples from, (B, V) f32:
    the log-softmax of :func:`_sorted_masked`'s rows scattered back to
    vocab order; filtered tokens are -inf. ``temperature``/``top_p`` f32
    and ``top_k`` int of shape (B,)."""
    order, masked = _sorted_masked(logits, temperature, top_k, top_p)
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


def sample_logits(logits: torch.Tensor, temperature, top_k, top_p,
                  key: torch.Tensor) -> torch.Tensor:
    """One token id from a single row of logits (V,), consuming ``key``
    ((2,) threefry words, ``ops/prng``) as it is, unsplit (JAX
    ``sample_logits``). ``temperature`` <= 0 is greedy argmax; ``top_k``
    0 and ``top_p`` >= 1 disable their filters. Returns an int64
    scalar."""
    dev = logits.device
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    order, masked = _sorted_masked(
        logits[None], temp.reshape(1),
        torch.as_tensor(top_k, dtype=torch.int64, device=dev).reshape(1),
        torch.as_tensor(top_p, dtype=torch.float32, device=dev).reshape(1))
    choice = prng.categorical(key.reshape(1, 2), masked)
    sampled = order[0, choice[0]]
    return torch.where(temp > 0.0, sampled, logits.argmax(dim=-1))


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token per row and the advanced keys: ``(tokens (B,) int64,
    keys (B, 2))``.

    Each row's key (``keys`` (B, 2), ``ops/prng``) is split exactly once:
    the first half draws this sample (Gumbel-max over the sorted, masked
    row), the second is returned for the next step. Rows with
    ``temperature <= 0`` take ``argmax``."""
    halves = prng.split(keys, 2)
    greedy = logits.argmax(dim=-1)
    order, masked = _sorted_masked(logits, temperature, top_k, top_p)
    choice = prng.categorical(halves[:, 0], masked)
    sampled = order.gather(-1, choice[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy), halves[:, 1]


def greedy_accept(t_logits: torch.Tensor, draft_tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy draft-verify acceptance: the longest prefix where the
    target's argmax equals the draft token, and the argmax stream as the
    output (correction at the first mismatch, bonus at G), so greedy
    speculative decode is token-identical to greedy target decode.
    Returns ``(out (B, G+1), accepts (B,))``."""
    g_len = draft_tokens.shape[1]
    t_argmax = t_logits.argmax(dim=-1)                     # (B, G+1)
    match = (t_argmax[:, :g_len] == draft_tokens).long()
    return t_argmax, match.cumprod(dim=1).sum(dim=1)


def speculative_accept(t_logits: torch.Tensor, q_logp: torch.Tensor,
                       draft_tokens: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       keys: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched draft-verify acceptance (speculative decode).

    t_logits (B, G+1, V) raw target logits — position ``i < G`` judges
    ``draft_tokens[:, i]``, position G scores the bonus token; q_logp
    (B, G, V) the draft's filtered log-probs (what it sampled from);
    draft_tokens (B, G); per-row sampling state as in
    :func:`sample_batch`. Returns ``(out_tokens (B, G+1), accept_counts
    (B,), carry_keys (B, 2))``: row ``b`` commits
    ``out_tokens[b, :accept_counts[b] + 1]``.

    Greedy rows take :func:`greedy_accept`. Sampled rows split their key
    into four (uniforms, residuals, bonus, carry) and run rejection
    sampling: accept ``d_i`` with probability ``min(1, p(d_i)/q(d_i))``;
    at the first rejection draw from ``normalize(max(p - q, 0))`` (the
    target's own distribution when that mass is below ``1e-9``); after
    ``G`` acceptances draw a bonus token from the target at position G.
    Every row's key is consumed once a call, whatever it accepts."""
    b, g1, vocab = t_logits.shape
    g_len = g1 - 1
    greedy_out, greedy_count = greedy_accept(t_logits, draft_tokens)
    sub = prng.split(keys, 4)
    k_u, k_res, k_bonus, carry = sub.unbind(dim=1)
    per_pos = [t[:, None].expand(b, g1).reshape(-1)
               for t in (temperature, top_k, top_p)]
    p_logp = filtered_log_probs_batch(
        t_logits.reshape(b * g1, vocab), *per_pos).reshape(b, g1, vocab)
    drafts = draft_tokens.long()
    p_d = p_logp[:, :g_len].gather(-1, drafts[..., None])[..., 0]
    q_d = q_logp.gather(-1, drafts[..., None])[..., 0]
    accept = prng.uniform(k_u, (g_len,)) < torch.exp(p_d - q_d)
    count = accept.long().cumprod(dim=1).sum(dim=1)
    residual = torch.clamp_min(p_logp[:, :g_len].exp() - q_logp.exp(), 0.0)
    res_mass = residual.sum(dim=-1, keepdim=True)
    res_logits = torch.where(
        residual > 0.0, torch.log(torch.clamp_min(residual, _RESIDUAL_FLOOR)),
        float("-inf"))
    res_logits = torch.where(res_mass > _RESIDUAL_FLOOR, res_logits,
                             p_logp[:, :g_len])
    corrections = prng.categorical(prng.split(k_res, g_len), res_logits)
    bonus = prng.categorical(k_bonus, p_logp[:, g_len])
    replacements = torch.cat([corrections, bonus[:, None]], dim=1)
    padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    keep = torch.arange(g1, device=t_logits.device)[None, :] < count[:, None]
    sampled_out = torch.where(keep, padded, replacements)
    greedy_row = temperature <= 0.0
    out = torch.where(greedy_row[:, None], greedy_out, sampled_out)
    return out, torch.where(greedy_row, greedy_count, count), carry
