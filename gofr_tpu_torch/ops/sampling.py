"""Token sampling: temperature / top-k / top-p, per row, and speculative
draft-verify acceptance (counterpart of ``gofr_tpu/ops/sampling.py``).

Greedy rows (``temperature <= 0``) resolve to ``argmax``. Sampled rows draw
from their own ``torch.Generator`` (one per engine slot, seeded from the
request's seed), so a row's stream depends on its seed alone. The JAX
package draws with threefry keys; those bits are not reproduced here, so
the two agree on the filtered distribution (:func:`filtered_log_probs`),
not on sampled tokens.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

# Rows with temperature <= 0 are greedy; this floor only guards the
# division for rows whose sampled branch is discarded anyway.
_TEMP_FLOOR = 1e-6
# Residual distributions with less mass than this fall back to the plain
# target distribution (the residual is numerically all-zero only when
# draft and target agree almost exactly, where the fallback is harmless).
_RESIDUAL_FLOOR = 1e-9


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


def sampled_rows(generators: Sequence[Optional[torch.Generator]]
                 ) -> List[int]:
    """Indices of the rows that draw (those given a generator)."""
    return [i for i, gen in enumerate(generators) if gen is not None]


def sample_batch(logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]],
                 logp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row, (B,) int64.

    Every row starts as ``argmax``. A row with a generator (the caller
    passes one only for sampled rows that take part in this step) draws
    from its filtered distribution with that generator, which advances it
    by one draw. ``logp`` (B, V), when given, is that distribution
    already computed (:func:`filtered_log_probs_batch` of ``logits``)."""
    tokens = logits.argmax(dim=-1)
    rows = sampled_rows(generators)
    if not rows:
        return tokens
    idx = torch.as_tensor(rows, device=logits.device)
    if logp is None:
        logp = filtered_log_probs_batch(logits[idx], temperature[idx],
                                        top_k[idx], top_p[idx])
    else:
        logp = logp[idx]
    probs = logp.exp()
    for j, row in enumerate(rows):
        tokens[row] = torch.multinomial(probs[j], 1,
                                        generator=generators[row])[0]
    return tokens


def speculative_accept(t_logits: torch.Tensor, q_logp: Optional[torch.Tensor],
                       draft_tokens: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       generators: Sequence[Optional[torch.Generator]]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched draft-verify acceptance (speculative decode).

    t_logits (B, G+1, V) raw target logits — position ``i < G`` judges
    ``draft_tokens[:, i]``, position G scores the bonus token; q_logp
    (B, G, V) the draft's filtered log-probs (what it sampled from; read
    only for rows with a generator, and may be None when no row has one);
    draft_tokens (B, G); per-row sampling state as in
    :func:`sample_batch`. Returns ``(out_tokens (B, G+1), accept_counts
    (B,))``: row ``b`` commits ``out_tokens[b, :accept_counts[b] + 1]``.

    Greedy rows (no generator) accept the longest prefix where the
    target argmax equals the draft token, and their output is the argmax
    stream, so greedy speculative decode is token-identical to greedy
    target decode. Sampled rows run rejection sampling with their
    generator: accept ``d_i`` with probability ``min(1, p(d_i)/q(d_i))``;
    at the first rejection draw from ``normalize(max(p - q, 0))`` (the
    target's own distribution when that mass is below ``1e-9``); after
    ``G`` acceptances draw a bonus token from the target at position G.
    Each sampled row takes three draws per call (uniforms, residuals,
    bonus) whatever it accepts.
    """
    g_len = draft_tokens.shape[1]
    dev = t_logits.device
    t_argmax = t_logits.argmax(dim=-1)                     # (B, G+1)
    match = (t_argmax[:, :g_len] == draft_tokens).long()
    out = t_argmax.clone()
    accepts = match.cumprod(dim=1).sum(dim=1)
    rows = sampled_rows(generators)
    if not rows:
        return out, accepts
    idx = torch.as_tensor(rows, device=dev)
    n, vocab = len(rows), t_logits.shape[-1]
    per_pos = [t[idx].repeat_interleave(g_len + 1)
               for t in (temperature, top_k, top_p)]
    p_logp = filtered_log_probs_batch(
        t_logits[idx].reshape(n * (g_len + 1), vocab),
        *per_pos).reshape(n, g_len + 1, vocab)
    q_rows = q_logp[idx]                                   # (n, G, V)
    drafts = draft_tokens[idx].long()
    p_d = p_logp[:, :g_len].gather(-1, drafts[..., None])[..., 0]
    q_d = q_rows.gather(-1, drafts[..., None])[..., 0]
    uniforms = torch.stack([
        torch.rand(g_len, generator=generators[row], device=dev)
        for row in rows])
    accept = uniforms < torch.exp(p_d - q_d)               # ratio > 1 accepts
    count = accept.long().cumprod(dim=1).sum(dim=1)
    residual = torch.clamp_min(p_logp[:, :g_len].exp() - q_rows.exp(), 0.0)
    res_mass = residual.sum(dim=-1, keepdim=True)
    res_probs = torch.where(res_mass > _RESIDUAL_FLOOR, residual,
                            p_logp[:, :g_len].exp())
    bonus_probs = p_logp[:, g_len].exp()
    replacements = torch.empty((n, g_len + 1), dtype=torch.long, device=dev)
    for j, row in enumerate(rows):
        gen = generators[row]
        replacements[j, :g_len] = torch.multinomial(res_probs[j], 1,
                                                    generator=gen)[:, 0]
        replacements[j, g_len] = torch.multinomial(bonus_probs[j], 1,
                                                   generator=gen)[0]
    padded = torch.cat([drafts, torch.zeros((n, 1), dtype=torch.long,
                                            device=dev)], dim=1)
    keep = torch.arange(g_len + 1, device=dev)[None, :] < count[:, None]
    out[idx] = torch.where(keep, padded, replacements)
    accepts[idx] = count
    return out, accepts
