"""Attention ops, plain PyTorch (counterpart of ``gofr_tpu/ops/attention.py``).

These are the plain versions the CUDA kernels are held to:

- GQA reshapes Q to (kv_heads, group, ...) and lets the einsum broadcast
  over the group axis, so no repeated K/V copy is made.
- Decode and speculative verify attend over a static-shape cache with a
  length mask; decode is verify with one query.
- The decode/verify formulation computes in float32 with explicit
  rounding points (:func:`_snap`) where the low-precision formulation
  rounds: the score einsums, the normalised probabilities, the value
  einsums and the final add. The ragged decode and verify kernels
  reproduce that schedule, int8 caches (per-vector scales) included.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30  # large negative instead of -inf: keeps softmax NaN-free


def _snap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round float32 values to ``dtype``'s precision without leaving
    float32 (round to nearest even, as ``lax.reduce_precision`` does).

    Eager PyTorch runs the two casts as written; do not wrap this in
    ``torch.compile``, which may fold the round trip away. float32 and
    wider pass through untouched."""
    if torch.finfo(dtype).bits >= 32:
        return x
    return x.to(dtype).to(torch.float32)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(seq, seq) boolean mask, True where attention is allowed."""
    return torch.ones((seq_len, seq_len), dtype=torch.bool,
                      device=device).tril()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head (optionally grouped-query) attention.

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) with Hq % Hkv == 0.
    mask: broadcastable to (B, 1, 1, S, T), True = attend.
    Returns (B, S, Hq, D) in q.dtype.
    """
    batch, s_len, q_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    group = q_heads // kv_heads
    qg = q.reshape(batch, s_len, kv_heads, group, head_dim)
    scale = head_dim ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v)
    return out.reshape(batch, s_len, q_heads, head_dim)


def prefill_attention(q, k, v) -> torch.Tensor:
    """Causal self-attention over a full prompt (prefill phase)."""
    mask = causal_mask(q.shape[1], device=q.device)[None, None, None]
    return attention(q, k, v, mask)


def prefix_prefill_attention(q, k, v, prefix_len: int) -> torch.Tensor:
    """Causal attention for a suffix prefill over cached-prefix + suffix
    K/V (prefix KV reuse, ``tpu/prefix_cache``; JAX
    ``prefix_prefill_attention``, the reference's route for the suffix
    rows). ``llama.prefill`` takes it without ``cfg.use_flash``; with
    it, the flash kernel over zero queries in the prefix's place, whose
    bits are a full prefill's.

    q: (B, S, Hq, D), the S suffix tokens at absolute positions
    ``prefix_len + i``; k, v: (B, prefix_len + S, Hkv, D), the cached
    prefix K/V followed by the suffix's, in position order. Query ``i``
    attends key ``j <= prefix_len + i``: the whole prefix, then causally
    into the suffix."""
    s_len, t_len = q.shape[1], k.shape[1]
    pos = torch.arange(t_len, device=q.device)
    mask = pos[None, :] <= prefix_len + torch.arange(s_len,
                                                     device=q.device)[:, None]
    return attention(q, k, v, mask[None, None, None])


def gather_kv_pages(pages: torch.Tensor,
                    page_table: torch.Tensor) -> torch.Tensor:
    """Gather a per-slot contiguous KV view out of a shared page pool.

    pages: (num_pages, page, ...) — one pool leaf, layer already indexed.
    page_table: (B, P) int — page ids per slot in sequence order; entries
    equal to num_pages are the unallocated sentinel. Returns
    (B, P * page, ...).

    JAX gathers clamp an out-of-bounds id; PyTorch indexing raises on
    one, so the sentinel is clamped here explicitly to the last pool row.
    The clamped rows land at positions >= cache_len, which every consumer
    masks (scores to _NEG_INF, V rows to zero in
    :func:`decode_attention_cached`).
    """
    num_pages, page = pages.shape[0], pages.shape[1]
    b, p = page_table.shape
    ids = page_table.long().clamp(0, num_pages - 1)
    gathered = pages[ids]                              # (B, P, page, ...)
    return gathered.reshape(b, p * page, *pages.shape[2:])


def verify_attention(q, k_cache, v_cache, k_new, v_new, cache_len,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-query decode attention for speculative verify: query ``g``
    sits at position ``cache_len + g`` and attends every prior cache
    entry (``t < cache_len``) plus the G new tokens' own K/V causally
    (key ``u <= g``). The new K/V ride along explicitly; the caller
    writes them into the cache afterwards.

    q: (B, G, Hq, D); caches: (B, Tmax, Hkv, D); k_new/v_new:
    (B, G, Hkv, D); cache_len: (B,) valid entries excluding the G new
    tokens. Returns (B, G, Hq, D).

    Float32 throughout with the oracle's rounding points (:func:`_snap`):
    the score einsums, the normalised cache probabilities, the two value
    einsums and their sum. V rows at or past ``cache_len`` are zeroed
    before the P·V product, so a NaN in a dead row (a clamped sentinel
    page, say) cannot poison the output through ``0 * NaN``; with finite
    V this changes nothing.

    int8 caches (``ops/quant.quantize_kv``) pass ``k_scale``/``v_scale``
    (B, Tmax, Hkv): the K scale multiplies the float32 scores after the
    rounded einsum and ``* scale``; the cache probabilities are not
    rounded but multiplied by the V scale before a float32 P·V einsum.
    The V scale is zeroed past ``cache_len`` like the V rows. The new
    tokens' K/V arrive unquantised and take the bf16 path.
    """
    batch, g_len, q_heads, head_dim = q.shape
    t_max, kv_heads = k_cache.shape[1], k_cache.shape[2]
    group = q_heads // kv_heads
    dt = q.dtype
    dev = q.device
    qg = q.reshape(batch, g_len, kv_heads, group, head_dim).float()
    scale = head_dim ** -0.5
    valid = (torch.arange(t_max, device=dev)[None, :]
             < cache_len.to(dev)[:, None])                  # (B, T)

    scores = _snap(torch.einsum("bskgd,btkd->bkgst", qg, k_cache.float()),
                   dt) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG_INF)
    scores_new = _snap(torch.einsum("bskgd,bukd->bkgsu", qg, k_new.float()),
                       dt) * scale
    causal = (torch.arange(g_len, device=dev)[None, :]
              <= torch.arange(g_len, device=dev)[:, None])  # (S, U)
    scores_new = torch.where(causal, scores_new, _NEG_INF)
    scores = torch.cat([scores, scores_new], dim=-1)        # (B,K,G,S,T+S)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs_cache = probs[..., :-g_len]
    if v_scale is not None:
        v_scale = torch.where(valid[:, :, None], v_scale, 0.0)
        probs_cache = probs_cache * v_scale.permute(0, 2, 1)[:, :, None,
                                                             None, :]
    else:
        probs_cache = _snap(probs_cache, dt)
    v_live = torch.where(valid[:, :, None, None], v_cache.float(), 0.0)
    out = _snap(torch.einsum("bkgst,btkd->bskgd", probs_cache, v_live), dt)
    out_new = _snap(torch.einsum("bkgsu,bukd->bskgd",
                                 _snap(probs[..., -g_len:], dt),
                                 v_new.float()), dt)
    out = _snap(out + out_new, dt)
    return out.reshape(batch, g_len, q_heads, head_dim).to(dt)


def decode_attention_cached(q, k_cache, v_cache, k_new, v_new, cache_len,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Decode attention over (prior cache entries + the current token's
    K/V), the new token carried explicitly (the caller writes it into the
    cache afterwards): :func:`verify_attention` with one query, so a
    G = 1 verify is bit-identical to a decode step by construction.

    q: (B, 1, Hq, D); caches: (B, Tmax, Hkv, D); k_new/v_new: (B, Hkv, D);
    cache_len: (B,) valid entries excluding the current token; int8
    caches pass ``k_scale``/``v_scale`` (B, Tmax, Hkv).
    Returns (B, 1, Hq, D).
    """
    return verify_attention(q, k_cache, v_cache, k_new[:, None],
                            v_new[:, None], cache_len, k_scale, v_scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, k_new, v_new,
                           cache_len, k_scale_pages=None,
                           v_scale_pages=None) -> torch.Tensor:
    """Ragged paged decode attention, gather formulation: gathers each
    slot's pages (sentinels clamped) into a dense view and runs
    :func:`decode_attention_cached` over it (:func:`paged_verify_attention`
    with one query).

    q: (B, 1, Hq, D); k_pages/v_pages: (num_pages, page, Hkv, D);
    page_table: (B, P) int; k_new/v_new: (B, Hkv, D); cache_len: (B,);
    int8 pools pass ``k_scale_pages``/``v_scale_pages`` (num_pages, page,
    Hkv).
    """
    return paged_verify_attention(q, k_pages, v_pages, page_table,
                                  k_new[:, None], v_new[:, None], cache_len,
                                  k_scale_pages, v_scale_pages)


def paged_verify_attention(q, k_pages, v_pages, page_table, k_new, v_new,
                           cache_len, k_scale_pages=None,
                           v_scale_pages=None) -> torch.Tensor:
    """Paged variant of :func:`verify_attention`, gather formulation.
    q: (B, G, Hq, D); k_pages/v_pages: (num_pages, page, Hkv, D);
    page_table: (B, P) int; k_new/v_new: (B, G, Hkv, D); cache_len: (B,);
    int8 pools pass ``k_scale_pages``/``v_scale_pages`` (num_pages, page,
    Hkv), gathered like the pages. Returns (B, G, Hq, D)."""
    k_cache = gather_kv_pages(k_pages, page_table)
    v_cache = gather_kv_pages(v_pages, page_table)
    k_scale = v_scale = None
    if k_scale_pages is not None:
        k_scale = gather_kv_pages(k_scale_pages, page_table)
        v_scale = gather_kv_pages(v_scale_pages, page_table)
    return verify_attention(q, k_cache, v_cache, k_new, v_new, cache_len,
                            k_scale, v_scale)
