"""Llama-family decoder for the ``/generate`` path (counterpart of
``gofr_tpu/models/llama.py``).

- Params are a plain dict of tensors with the JAX package's layout:
  per-layer weights stacked on a leading (L, ...) axis, linears stored
  (in, out). The layer loop is a Python loop over views of those stacks.
- Weights and activations in the config's dtype (bf16 by default); norms,
  softmax and logits in float32.
- Prefill attention goes through the flash-attention wrapper when
  ``cfg.use_flash`` is set; dense decode attention (:func:`decode_step`,
  the speculative draft's step) always goes through the flash-decode
  wrapper, and paged decode and paged verify attention always go through
  the ragged paged wrappers. Each wrapper launches its CUDA kernel on a
  CUDA tensor and runs its plain version on a CPU tensor.
- ``kv_int8`` stores K/V as int8 plus per-(token, head) float32 scales
  (``ops/quant.quantize_kv``) on every cache and pool write; paged decode
  and verify read them through the ragged kernel's int8 instantiation.
- The paged KV pool and the dense cache are updated in place (indexed
  assignment), where the JAX package threaded them through a scan carry.
  PyTorch has no dropping scatter (JAX's ``mode="drop"``): a paged write
  that must not land (an inactive slot, a sentinel page, a position past
  the table) is routed to the pool's scratch page at the sentinel id
  (``tpu/page_pool``), and a dense write past the cache writes back what
  its clamped destination holds. Every write has the same shape whatever
  the data, so a step makes no host sync and a CUDA graph can capture it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops.attention import prefill_attention
from gofr_tpu_torch.ops.cuda.decode_attention import flash_decode_attention
from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention, ragged_paged_verify_attention)
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.quant import qmm, quantize_kv
from gofr_tpu_torch.ops.rotary import apply_rope, rope_table

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # prefill attention through the flash-attention kernel wrapper
    use_flash: bool = False
    # int8 KV cache: K/V rows int8 plus per-(token, head) float32 scales
    # (ops/quant.quantize_kv), half the bf16 cache's bytes: the capacity
    # lever (more slots or longer contexts per card). Paged decode and
    # verify dequantise inside the ragged kernel; the dense decode_step
    # (flash decode reads a bf16 cache) refuses it.
    kv_int8: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


PRESETS: Dict[str, LlamaConfig] = {
    # tiny: unit tests (the JAX package's test geometry)
    "tiny": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq_len=128),
    "small": LlamaConfig(vocab_size=32000, dim=1024, n_layers=8, n_heads=16,
                         n_kv_heads=16, ffn_dim=2816, max_seq_len=2048),
    "7b": LlamaConfig(),  # Llama-2-7B geometry
    # Llama-3-8B geometry: GQA 32:8, 128K vocab, rope theta 500k
    "llama3-8b": LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, ffn_dim=14336,
                             max_seq_len=8192, rope_theta=500000.0),
}


def config(preset: str = "tiny", **overrides) -> LlamaConfig:
    return dataclasses.replace(PRESETS[preset], **overrides)


def init(cfg: LlamaConfig, seed: int = 0,
         device: Union[str, torch.device] = "cuda") -> Params:
    """Random params drawn on ``device`` from a seeded generator: normal
    with std 1/sqrt(fan_in) for linears and the embedding, ones for the
    norms. Drawn one layer at a time, so the float32 draw never holds more
    than one layer's tensor."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = cfg.dtype
    d, f, n = cfg.dim, cfg.ffn_dim, cfg.n_layers
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(fan_in))).to(dt)

    def stacked(shape, fan_in):
        out = torch.empty((n, *shape), dtype=dt, device=dev)
        for i in range(n):
            out[i] = dense(shape, fan_in)
        return out

    return {
        "tok_emb": dense((cfg.vocab_size, d), d),
        "layers": {
            "attn_norm": torch.ones((n, d), dtype=dt, device=dev),
            "wq": stacked((d, qd), d),
            "wk": stacked((d, kvd), d),
            "wv": stacked((d, kvd), d),
            "wo": stacked((qd, d), qd),
            "ffn_norm": torch.ones((n, d), dtype=dt, device=dev),
            "w_gate": stacked((d, f), d),
            "w_up": stacked((d, f), d),
            "w_down": stacked((f, d), f),
        },
        "out_norm": torch.ones((d,), dtype=dt, device=dev),
        "lm_head": dense((d, cfg.vocab_size), d),
    }


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, torch.Tensor]:
    """Per-layer dense KV cache (L, B, T, Hkv, D), zero-initialised: the
    small cache a prefill fills before the engine scatters it into pool
    pages, or the speculative draft's per-slot cache. With
    ``cfg.kv_int8`` k/v are int8 and ``ks``/``vs`` (L, B, T, Hkv) float32
    scale planes, initialised to ones."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    if cfg.kv_int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.ones(shape[:-1], dtype=torch.float32,
                                 device=dev),
                "vs": torch.ones(shape[:-1], dtype=torch.float32,
                                 device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _kv_rows(cfg: LlamaConfig, k: torch.Tensor,
             v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """What a cache or pool write stores for these K/V rows, by leaf:
    the rows themselves, or with ``cfg.kv_int8`` their int8 quantisation
    and scales."""
    if not cfg.kv_int8:
        return {"k": k, "v": v}
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "v": vq, "ks": ks, "vs": vs}


def _scale_planes(cfg: LlamaConfig, pool: Dict[str, torch.Tensor],
                  i: int, num_pages: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Layer ``i``'s K and V scale planes of an int8 pool without the
    scratch row, else Nones."""
    if not cfg.kv_int8:
        return None, None
    return pool["ks"][i][:num_pages], pool["vs"][i][:num_pages]


def _layer(params: Params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights: views into the stacked (L, ...) tensors (or
    into both halves of an int8 quant dict)."""
    def pick(w):
        if isinstance(w, dict):
            return {key: val[i] for key, val in w.items()}
        return w[i]
    return {name: pick(w) for name, w in params["layers"].items()}


def _qkv(layer, x, cfg, cos, sin, positions):
    b, s, _ = x.shape
    q = qmm(x, layer["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = qmm(x, layer["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = qmm(x, layer["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, cos, sin, positions), \
        apply_rope(k, cos, sin, positions), v


def _ffn(layer, x):
    gate = F.silu(qmm(x, layer["w_gate"]).float())
    up = qmm(x, layer["w_up"]).float()
    return qmm((gate * up).to(x.dtype), layer["w_down"])


def _rope(cfg: LlamaConfig, device: torch.device):
    return rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                      device=device)


def _run_prompt(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """The layer stack over a whole prompt (causal attention from 0);
    returns the final hidden states (B, S, D). With ``cache`` given, each
    layer's K/V is written into it in place."""
    b, s = tokens.shape
    dev = tokens.device
    cos, sin = _rope(cfg, dev)
    positions = torch.arange(s, device=dev).expand(b, s)
    attend = flash_attention if cfg.use_flash else prefill_attention
    x = params["tok_emb"][tokens]
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        x = x + qmm(attend(q, k, v).reshape(b, s, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(layer, h)
        if cache is not None:
            for name, rows in _kv_rows(cfg, k, v).items():
                cache[name][i, :, :s] = rows
    return x


def forward(params: Params, cfg: LlamaConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full causal forward → logits (B, S, V) in float32."""
    x = rms_norm(_run_prompt(params, cfg, tokens), params["out_norm"],
                 cfg.norm_eps)
    return qmm(x, params["lm_head"]).float()


def prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor],
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Run the prompt and fill ``cache`` (L, B, T >= S, Hkv, D) in place
    (quantised, with its scale planes, under ``cfg.kv_int8``).
    Returns (last-token logits (B, V) f32, cache, cache_len (B,) int32).

    ``lengths`` (B,) supports right-padded prompts: logits are taken at
    position ``lengths - 1`` of each row and cache_len = lengths.
    """
    b, s = tokens.shape
    dev = tokens.device
    x = _run_prompt(params, cfg, tokens, cache)
    if lengths is None:
        last = x[:, -1]
        cache_len = torch.full((b,), s, dtype=torch.int32, device=dev)
    else:
        lengths = lengths.to(dev)
        last = x[torch.arange(b, device=dev), lengths.long() - 1]
        cache_len = lengths.to(torch.int32)
    last = rms_norm(last, params["out_norm"], cfg.norm_eps)
    return qmm(last, params["lm_head"]).float(), cache, cache_len


def decode_step_paged(params: Params, cfg: LlamaConfig, token: torch.Tensor,
                      pool: Dict[str, torch.Tensor],
                      page_table: torch.Tensor, cache_len: torch.Tensor,
                      active: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                 torch.Tensor]:
    """One decode step over the paged KV pool.

    token (B,) int; ``pool`` {"k", "v"} leaves (L, num_pages + 1, page,
    Hkv, D) whose last page row is scratch (``tpu/page_pool``), with
    ``cfg.kv_int8`` int8 plus {"ks", "vs"} (L, num_pages + 1, page, Hkv)
    float32 scale planes; page_table (B, P) int32 with ``num_pages`` as
    the unallocated sentinel; cache_len (B,) int32 valid tokens excluding
    this one; active (B,) bool gates the append. Attention runs through
    the ragged paged decode wrapper over the first ``num_pages`` rows,
    then the new K/V row (quantised under ``kv_int8``) is written in place
    at page ``cache_len // page``, offset ``cache_len % page``. Returns
    (logits (B, V) f32, pool, cache_len + 1); the caller freezes inactive
    rows' cache_len.

    Inactive rows must not write: the pool is shared and their page may
    belong to another slot by now. As JAX routes them to the sentinel
    with ``mode="drop"``, their write (and any whose table entry is the
    sentinel) goes to the scratch page: one write of all B rows, no host
    sync.
    """
    b = token.shape[0]
    dev = token.device
    cos, sin = _rope(cfg, dev)
    positions = cache_len.long()[:, None]
    num_pages, page = pool["k"].shape[1] - 1, pool["k"].shape[2]
    # the append destination is the same for every layer: hoist it.
    # take_along_axis(mode="clip") in JAX: clamp the column explicitly
    page_col = (cache_len.long() // page).clamp(0, page_table.shape[1] - 1)
    page_row = page_table.long().gather(1, page_col[:, None])[:, 0]
    keep = active & (page_row < num_pages)
    dest_row = torch.where(keep, page_row, num_pages)
    dest_off = torch.where(keep, cache_len.long() % page, 0)
    x = params["tok_emb"][token][:, None, :]              # (B, 1, D)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k_new, v_new = k[:, 0].contiguous(), v[:, 0].contiguous()
        attn = ragged_paged_decode_attention(
            q.contiguous(), pool["k"][i][:num_pages],
            pool["v"][i][:num_pages], page_table, k_new, v_new, cache_len,
            *_scale_planes(cfg, pool, i, num_pages))
        x = x + qmm(attn.reshape(b, 1, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(layer, h)
        # in-place append into the shared pool (dropped rows: scratch)
        for name, rows in _kv_rows(cfg, k_new, v_new).items():
            pool[name][i][dest_row, dest_off] = rows
    x = rms_norm(x[:, 0], params["out_norm"], cfg.norm_eps)
    logits = qmm(x, params["lm_head"]).float()
    return logits, pool, cache_len + 1


def decode_step(params: Params, cfg: LlamaConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
    """One decode step over a dense cache (L, B, T, Hkv, D).

    token (B,) int; cache_len (B,) int32 valid entries excluding this
    token. Attention runs over the cache plus the new K/V through the
    flash-decode wrapper, then the new row is written in place at
    ``cache_len``. A row whose position is past the cache writes nothing
    (JAX dropped that scatter): it writes back what its clamped
    destination holds, so the step needs no host sync to filter it.
    Returns (logits (B, V) f32, cache, cache_len + 1).

    A ``kv_int8`` config raises ValueError: the flash-decode kernel reads
    a bf16 cache (the JAX package's ``kv_int8`` / ``use_flash_decode``
    exclusion), and the dense int8 cache is not ported.
    """
    if cfg.kv_int8:
        raise ValueError("decode_step: the dense cache is bf16 only (flash "
                         "decode reads a bf16 cache); kv_int8 runs on the "
                         "paged pool (decode_step_paged)")
    b = token.shape[0]
    dev = token.device
    cos, sin = _rope(cfg, dev)
    positions = cache_len.long()[:, None]
    t_max = cache["k"].shape[2]
    rows = torch.arange(b, device=dev)
    cols = cache_len.long().clamp(max=t_max - 1)
    fits = (cache_len < t_max)[:, None, None]
    x = params["tok_emb"][token][:, None, :]              # (B, 1, D)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k_new, v_new = k[:, 0].contiguous(), v[:, 0].contiguous()
        attn = flash_decode_attention(q.contiguous(), k_cache, v_cache,
                                      k_new, v_new, cache_len)
        x = x + qmm(attn.reshape(b, 1, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(layer, h)
        k_cache[rows, cols] = torch.where(fits, k_new, k_cache[rows, cols])
        v_cache[rows, cols] = torch.where(fits, v_new, v_cache[rows, cols])
    x = rms_norm(x[:, 0], params["out_norm"], cfg.norm_eps)
    logits = qmm(x, params["lm_head"]).float()
    return logits, cache, cache_len + 1


def verify_step_paged(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                      pool: Dict[str, torch.Tensor],
                      page_table: torch.Tensor, cache_len: torch.Tensor,
                      active: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative verify over the paged KV pool: score G tokens per row
    in one forward.

    tokens (B, G) sit at positions ``cache_len + g``; pool (with its
    scratch row), page_table and active as in :func:`decode_step_paged`.
    Attention always runs through the ragged paged verify wrapper over
    the first ``num_pages`` rows (int8 pools with their scale planes
    under ``cfg.kv_int8``); the G new K/V rows of each row (quantised
    under ``kv_int8``) are then written in place at page
    ``(cache_len + g) // page``, offset ``(cache_len + g) % page``.
    Inactive rows, sentinel destinations and positions past the table's
    reach write the scratch page (JAX routed them to the sentinel page
    and dropped them). Returns (logits (B, G, V) f32, pool);
    ``cache_len`` is not advanced here — the caller commits the accepted
    prefix.
    """
    b, g_len = tokens.shape
    dev = tokens.device
    cos, sin = _rope(cfg, dev)
    positions = cache_len.long()[:, None] \
        + torch.arange(g_len, device=dev)[None, :]          # (B, G)
    num_pages, page = pool["k"].shape[1] - 1, pool["k"].shape[2]
    width = page_table.shape[1]
    # the write destinations are the same for every layer: hoist them
    page_col = positions // page
    page_row = page_table.long().gather(1, page_col.clamp(max=width - 1))
    keep = active[:, None] & (page_col < width) & (page_row < num_pages)
    dest_row = torch.where(keep, page_row, num_pages)
    dest_off = torch.where(keep, positions % page, 0)
    x = params["tok_emb"][tokens]                         # (B, G, D)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k, v = k.contiguous(), v.contiguous()
        attn = ragged_paged_verify_attention(
            q.contiguous(), pool["k"][i][:num_pages],
            pool["v"][i][:num_pages], page_table, k, v, cache_len,
            *_scale_planes(cfg, pool, i, num_pages))
        x = x + qmm(attn.reshape(b, g_len, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(layer, h)
        for name, rows in _kv_rows(cfg, k, v).items():
            pool[name][i][dest_row, dest_off] = rows
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    return qmm(x, params["lm_head"]).float(), pool
