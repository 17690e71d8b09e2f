"""Llama-family decoder for the ``/generate`` path (counterpart of
``gofr_tpu/models/llama.py``).

- Params are a plain dict of tensors with the JAX package's layout:
  per-layer weights stacked on a leading (L, ...) axis, linears stored
  (in, out). The layer loop is a Python loop over views of those stacks.
- Weights and activations in the config's dtype (bf16 by default); norms,
  softmax and logits in float32.
- Prefill attention goes through the flash-attention wrapper when
  ``cfg.use_flash`` is set. Paged decode and verify attention go through
  the ragged paged wrappers. Dense decode and verify attention
  (:func:`decode_step`, :func:`verify_step`) go through the same ragged
  wrappers, over the dense cache viewed as a pool of pages in slot order
  and an identity page table (:func:`identity_table`), which computes the
  dense function exactly; with ``cfg.use_flash_decode`` (the speculative
  draft's config) dense decode goes through the flash-decode wrapper
  instead. Each wrapper launches its CUDA kernel on a CUDA tensor and
  runs its plain version on a CPU tensor.
- ``window`` (a rung of the engine's attention-window ladder) bounds a
  dense step's attention read to the cache's first ``window`` positions;
  the write still goes into the full cache.
- ``kv_int8`` stores K/V as int8 plus per-(token, head) float32 scales
  (``ops/quant.quantize_kv``) on every cache and pool write; decode and
  verify, paged or dense, read them through the ragged kernel's int8
  instantiation.
- The paged KV pool and the dense cache are updated in place (indexed
  assignment), where the JAX package threaded them through a scan carry.
  PyTorch has no dropping scatter (JAX's ``mode="drop"``): a paged write
  that must not land (an inactive slot, a sentinel page, a position past
  the table) is routed to the pool's scratch page at the sentinel id
  (``tpu/page_pool``), and a dense write past the cache lands on the
  cache's last position with the value that position gets anyway
  (:func:`_dense_write`). Every write has the same shape whatever the
  data, so a step makes no host sync and a CUDA graph can capture it.
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
    # dense decode attention through the flash-decode kernel wrapper (the
    # speculative draft's route); off, dense decode and verify read the
    # cache through the ragged wrappers over an identity page table
    use_flash_decode: bool = False
    # int8 KV cache: K/V rows int8 plus per-(token, head) float32 scales
    # (ops/quant.quantize_kv), half the bf16 cache's bytes: the capacity
    # lever (more slots or longer contexts per card). Decode and verify,
    # paged or dense, dequantise inside the ragged kernel. Exclusive with
    # use_flash_decode (flash decode reads a bf16 cache).
    kv_int8: bool = False

    def __post_init__(self):
        if self.kv_int8 and self.use_flash_decode:
            raise ValueError(
                "kv_int8 and use_flash_decode are mutually exclusive: the "
                "flash-decode kernel reads a bf16 cache")

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
    dense engine's per-slot cache, the small cache a prefill fills before
    the engine inserts it, or the speculative draft's cache. With
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


def dense_page(t_max: int, window: Optional[int] = None) -> int:
    """The page of the identity table over a dense cache of ``t_max``
    positions read to ``window`` (None: all of them): 32 where it divides
    both, else the largest power of two that does."""
    span = math.gcd(t_max, window or t_max)
    page = 32
    while span % page:
        page //= 2
    return page


def identity_table(batch: int, t_max: int, window: Optional[int] = None,
                   device: Union[str, torch.device] = "cuda"
                   ) -> torch.Tensor:
    """The page table that makes a dense cache (B, T, Hkv, D), viewed as
    a pool of ``B * T / page`` pages in slot order (``page`` from
    :func:`dense_page`), read as itself: row ``b`` holds slot ``b``'s first
    ``window // page`` pages, ``b * (T // page) + j``. Contiguous int32
    (batch, window // page); no entry is a sentinel."""
    page = dense_page(t_max, window)
    width = (window or t_max) // page
    slots = torch.arange(batch, dtype=torch.int32, device=device)
    cols = torch.arange(width, dtype=torch.int32, device=device)
    return (slots[:, None] * (t_max // page) + cols[None, :]).contiguous()


def _dense_pool(cfg: LlamaConfig, cache: Dict[str, torch.Tensor], i: int,
                page: int) -> Tuple[torch.Tensor, ...]:
    """Layer ``i`` of a dense cache as the ragged wrappers' arguments: k
    and v pages (B * T / page, page, Hkv, D), then with ``cfg.kv_int8``
    the two scale planes (B * T / page, page, Hkv), else Nones. Views, no
    copy."""
    names = ("k", "v", "ks", "vs") if cfg.kv_int8 else ("k", "v")
    views = tuple(cache[name][i].view(-1, page, *cache[name].shape[3:])
                  for name in names)
    return views if cfg.kv_int8 else views + (None, None)


def _dense_plan(cache_len: torch.Tensor, g_len: int, t_max: int
                ) -> Tuple[torch.Tensor, ...]:
    """Where a step's G new rows go in a dense cache of T positions, the
    same for every layer and leaf: (rows (B, 1), positions clamped into
    the cache (B, G), which fit (B, G), the index g of the new row that
    lands on position T - 1 (B,), whether one does (B,))."""
    dev = cache_len.device
    lens = cache_len.long()
    pos = lens[:, None] + torch.arange(g_len, device=dev)[None, :]
    rows = torch.arange(lens.shape[0], device=dev)[:, None]
    return (rows, pos.clamp(max=t_max - 1), pos < t_max,
            (t_max - 1 - lens).clamp(0, g_len - 1), lens < t_max)


def _dense_write(leaf: torch.Tensor, new: torch.Tensor, plan) -> None:
    """Write ``new`` (B, G, ...) into ``leaf`` (B, T, ...) in place at the
    positions of ``plan`` (:func:`_dense_plan`); positions past T write
    nothing (JAX's ``mode="drop"``). Without a host sync to filter them,
    each dropped write lands on position T - 1 with the value that
    position gets anyway: the row's new entry for it, or what it holds,
    so duplicate destinations always agree."""
    rows, dest, fits, at_last, lands = plan
    tail = (1,) * (new.dim() - 2)
    last = leaf[:, -1:]                                   # (B, 1, ...)
    if new.shape[1] > 1:
        # a row that lands a new entry on T - 1 writes that entry there
        last = torch.where(lands.view(-1, 1, *tail),
                           new[rows[:, 0], at_last][:, None], last)
    leaf[rows, dest] = torch.where(fits.view(*fits.shape, *tail), new, last)


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
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                window: Optional[int] = None,
                table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
    """One decode step over a dense cache (L, B, T, Hkv, D).

    token (B,) int; cache_len (B,) int32 valid entries excluding this
    token. Attention runs over the cache's first ``window`` positions
    (None: all T; the caller keeps every active row's cache_len below
    it) plus the new K/V: through the ragged decode wrapper over the
    layer viewed as a pool of pages and ``table``, the identity table of
    this window (:func:`identity_table`, built here when None), or with
    ``cfg.use_flash_decode`` through the flash-decode wrapper over the
    window's view. A row whose fill is past the window attends the whole
    window (JAX's ``v[:, :window]``). The new row (quantised with its
    scales under ``cfg.kv_int8``) is then written in place at
    ``cache_len`` in the full cache, never the window; a row whose
    position is past the cache writes nothing (:func:`_dense_write`).
    Returns (logits (B, V) f32, cache, cache_len + 1).
    """
    b = token.shape[0]
    dev = token.device
    cos, sin = _rope(cfg, dev)
    positions = cache_len.long()[:, None]
    t_max = cache["k"].shape[2]
    w = window or t_max
    page = dense_page(t_max, window)
    if table is None and not cfg.use_flash_decode:
        table = identity_table(b, t_max, window, device=dev)
    # the write destinations are the same for every layer: hoist them
    plan = _dense_plan(cache_len, 1, t_max)
    x = params["tok_emb"][token][:, None, :]              # (B, 1, D)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k_new, v_new = k[:, 0].contiguous(), v[:, 0].contiguous()
        if cfg.use_flash_decode:
            attn = flash_decode_attention(
                q.contiguous(), cache["k"][i][:, :w], cache["v"][i][:, :w],
                k_new, v_new, cache_len)
        else:
            k_pages, v_pages, k_scales, v_scales = _dense_pool(cfg, cache, i,
                                                               page)
            attn = ragged_paged_decode_attention(
                q.contiguous(), k_pages, v_pages, table, k_new, v_new,
                cache_len, k_scales, v_scales)
        x = x + qmm(attn.reshape(b, 1, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(layer, h)
        for name, rows in _kv_rows(cfg, k_new, v_new).items():
            _dense_write(cache[name][i], rows[:, None], plan)
    x = rms_norm(x[:, 0], params["out_norm"], cfg.norm_eps)
    logits = qmm(x, params["lm_head"]).float()
    return logits, cache, cache_len + 1


def verify_step(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
                window: Optional[int] = None,
                table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative verify over a dense cache: score G tokens per row in
    one forward.

    tokens (B, G) sit at positions ``cache_len + g``. Attention runs
    through the ragged verify wrapper over the layer's first ``window``
    positions viewed as pages and ``table`` (as in :func:`decode_step`;
    int8 caches with their scale planes); the G new K/V rows of each row
    (quantised under ``cfg.kv_int8``) are then written in place at
    ``cache_len + g`` in the full cache, positions past it dropped
    (:func:`_dense_write`). Returns (logits (B, G, V) f32, cache);
    ``cache_len`` is not advanced here — the caller commits the accepted
    prefix.
    """
    b, g_len = tokens.shape
    dev = tokens.device
    cos, sin = _rope(cfg, dev)
    positions = cache_len.long()[:, None] \
        + torch.arange(g_len, device=dev)[None, :]          # (B, G)
    t_max = cache["k"].shape[2]
    page = dense_page(t_max, window)
    if table is None:
        table = identity_table(b, t_max, window, device=dev)
    plan = _dense_plan(cache_len, g_len, t_max)
    x = params["tok_emb"][tokens]                         # (B, G, D)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k, v = k.contiguous(), v.contiguous()
        k_pages, v_pages, k_scales, v_scales = _dense_pool(cfg, cache, i,
                                                           page)
        attn = ragged_paged_verify_attention(
            q.contiguous(), k_pages, v_pages, table, k, v, cache_len,
            k_scales, v_scales)
        x = x + qmm(attn.reshape(b, g_len, -1), layer["wo"])
        h = rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        x = x + _ffn(layer, h)
        for name, rows in _kv_rows(cfg, k, v).items():
            _dense_write(cache[name][i], rows, plan)
    x = rms_norm(x, params["out_norm"], cfg.norm_eps)
    return qmm(x, params["lm_head"]).float(), cache


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
