"""Llama-family decoder for the ``/generate`` path (counterpart of
``gofr_tpu/models/llama.py``).

- Params are a plain dict of tensors with the JAX package's layout:
  per-layer weights stacked on a leading (L, ...) axis, linears stored
  (in, out). The layer loop is a Python loop over views of those stacks.
- Weights and activations in the config's dtype (bf16 by default); norms,
  softmax and logits in float32.
- Prefill attention goes through the flash-attention wrapper when
  ``cfg.use_flash`` is set, a suffix prefill over a cached prefix too
  (zero queries in the prefix's place). Paged decode and verify
  attention go through the ragged paged wrappers. Dense decode and
  verify attention (:func:`decode_step`, :func:`verify_step`) go through
  the same ragged wrappers, over the dense cache viewed as a pool of
  pages in slot order and an identity page table
  (:func:`identity_table`), which computes the dense function exactly;
  with ``cfg.use_flash_decode`` (the speculative draft's config) dense
  decode goes through the flash-decode wrapper instead. Each wrapper
  launches its CUDA kernel on a CUDA tensor and runs its plain version
  on a CPU tensor. ``ragged=False`` on the paged steps asks for JAX's
  gather formulation instead (the engine's ``ragged_attn="off"``).
- ``quantize_params`` (int8 weights, ``ops/quant``) and ``generate``
  (prefill, then decode steps, JAX's key schedule) as in JAX.
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
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops import prng
from gofr_tpu_torch.ops.attention import (paged_decode_attention,
                                          paged_verify_attention,
                                          prefill_attention,
                                          prefix_prefill_attention)
from gofr_tpu_torch.ops.cuda.decode_attention import flash_decode_attention
from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
from gofr_tpu_torch.ops.cuda.ragged_paged_attention import (
    ragged_paged_decode_attention, ragged_paged_verify_attention)
from gofr_tpu_torch.ops.norms import rms_norm
from gofr_tpu_torch.ops.quant import qmm, quantize_kv, quantize_tree
from gofr_tpu_torch.ops.rotary import apply_rope, rope_table
from gofr_tpu_torch.parallel.collectives import Group

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
    # the head counts are the weights' widths over head_dim: a tp rank's
    # column slice holds n_heads / tp and n_kv_heads / tp heads
    b, s, _ = x.shape
    q = qmm(x, layer["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = qmm(x, layer["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = qmm(x, layer["wv"]).reshape(b, s, -1, cfg.head_dim)
    return apply_rope(q, cos, sin, positions), \
        apply_rope(k, cos, sin, positions), v


def _ffn(layer, x):
    gate = F.silu(qmm(x, layer["w_gate"]).float())
    up = qmm(x, layer["w_up"]).float()
    return qmm((gate * up).to(x.dtype), layer["w_down"])


def quantize_params(params: Params) -> Params:
    """int8 weight-only quantisation of every matmul weight (attention,
    FFN, lm_head; ``ops/quant.quantize_tree``); norms and the embedding
    stay as they are. ``qmm`` reads the result."""
    return quantize_tree(params)


def _rope(cfg: LlamaConfig, device: torch.device):
    return rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta,
                      device=device)


def _prefix_kv(cfg: LlamaConfig, prefix: Dict[str, torch.Tensor],
               i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s cached prefix K and V (B, prefix_len, Hkv, D) in
    ``cfg.dtype``: int8 rows dequantised as JAX does, both factors cast to
    the compute dtype and multiplied there."""
    pk, pv = prefix["k"][i], prefix["v"][i]
    if cfg.kv_int8:
        pk = pk.to(cfg.dtype) * prefix["ks"][i][..., None].to(cfg.dtype)
        pv = pv.to(cfg.dtype) * prefix["vs"][i][..., None].to(cfg.dtype)
    return pk, pv


def _flash_suffix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  prefix_len: int) -> torch.Tensor:
    """The suffix rows of causal flash attention over the whole prompt:
    zero queries stand in for the ``prefix_len`` cached rows (their
    outputs are dropped), so each suffix row attends keys
    ``j <= prefix_len + i`` through the flash kernel exactly as a full
    prefill of the prompt computes that row (a row's walk over the keys
    and its sums do not depend on the other rows)."""
    pad = q.new_zeros((q.shape[0], prefix_len) + q.shape[2:])
    return flash_attention(torch.cat([pad, q], dim=1), k, v)[:, prefix_len:]


class TPShards(list):
    """A tensor-parallel group's params: rank r's tree of plain tensors
    (its column and row slices of ``parallel/sharding.
    llama_param_specs``, on its device) at index r, and ``group`` the
    collectives between the ranks (``parallel/collectives.Group``).
    Every step of this module takes it in the params' place; the caches
    and pools it reads are then lists of the ranks' trees (rank r's
    kv heads ``[r * Hkv / tp, (r + 1) * Hkv / tp)``)."""

    def __init__(self, ranks: Sequence[Params], group):
        super().__init__(ranks)
        self.group = group


def _ranks(params) -> Tuple[Any, List[Params]]:
    """(the collectives, the ranks' params): a group of one rank for a
    plain tree, whose collectives hand its one part back unchanged."""
    if isinstance(params, TPShards):
        return params.group, list(params)
    return Group([params["tok_emb"].device]), [params]


def rank_trees(tree, n: int = 1) -> list:
    """A cache, pool or prefix as the ranks' trees: a plain tree is the
    one rank's, None every rank's."""
    if tree is None:
        return [None] * n
    return [tree] if isinstance(tree, dict) else list(tree)


def rank_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """One of ``tp`` ranks' geometry: n_heads, n_kv_heads, dim and
    ffn_dim divided by ``tp``, so head_dim is the model's. For the KV
    shapes a rank holds (``init_cache``, page bytes) and the kernels'
    refusals; the layers take their widths from the weights."""
    if tp == 1:
        return cfg
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               dim=cfg.dim // tp, ffn_dim=cfg.ffn_dim // tp)


def _rank_ropes(cfg: LlamaConfig, xs: List[torch.Tensor],
                positions: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
    """(cos, sin, positions) on each rank's device, made once a device."""
    made: Dict[str, Tuple[torch.Tensor, ...]] = {}
    out = []
    for x in xs:
        key = str(x.device)
        if key not in made:
            made[key] = _rope(cfg, x.device) + (positions.to(x.device),)
        out.append(made[key])
    return out


def _embed(group, ranks: List[Params],
           tokens: torch.Tensor) -> List[torch.Tensor]:
    """The (replicated) embedding rows of ``tokens`` on each rank."""
    return [p["tok_emb"][t] for p, t in zip(ranks, group.broadcast(tokens))]


def _stack(group, ranks: List[Params], xs: List[torch.Tensor],
           cfg: LlamaConfig, attend, ffn=None, ffn_group=None
           ) -> List[torch.Tensor]:
    """The layer stack over a tp group (one rank unsharded): at each
    layer, each rank's attention over its heads (``attend(r, i, layer,
    h)`` → (B, S, Hq_r·D), writing the rank's K/V), its rows of ``wo``,
    one all-reduce; then each rank's FFN slice (``ffn(layer, h)``, the
    dense FFN by default) and one all-reduce, or with ``ffn_group(i,
    hs)`` given (the ep-sharded MoE) that call's FFN outputs, already
    reduced over its own ranks, on each tp rank's device. ``xs`` is the
    residual stream on each rank's device; returns it after the last
    layer."""
    ffn = ffn or _ffn
    for i in range(cfg.n_layers):
        layers = [_layer(p, i) for p in ranks]
        parts = [qmm(attend(r, i, layer,
                            rms_norm(xs[r], layer["attn_norm"],
                                     cfg.norm_eps)), layer["wo"])
                 for r, layer in enumerate(layers)]
        xs = [x + y for x, y in zip(xs, group.all_reduce(parts))]
        hs = [rms_norm(xs[r], layer["ffn_norm"], cfg.norm_eps)
              for r, layer in enumerate(layers)]
        if ffn_group is not None:
            outs = ffn_group(i, hs)
        else:
            outs = group.all_reduce([ffn(layer, h)
                                     for layer, h in zip(layers, hs)])
        xs = [x + y for x, y in zip(xs, outs)]
    return xs


def _logits(group, ranks: List[Params], xs: List[torch.Tensor],
            cfg: LlamaConfig) -> torch.Tensor:
    """float32 logits of the final hidden rows: each rank's vocab slice
    of ``lm_head``, gathered along the vocab (on rank 0's device)."""
    parts = [qmm(rms_norm(x, p["out_norm"], cfg.norm_eps),
                 p["lm_head"]).float() for x, p in zip(xs, ranks)]
    return group.all_gather(parts, dim=-1)[0]


def _prompt_stack(params, cfg: LlamaConfig, tokens: torch.Tensor,
                  cache=None, prefix=None, prefix_len: int = 0, ffn=None,
                  attend_fn=None, ffn_group=None):
    """The layer stack over a whole prompt (causal attention from 0), or
    with ``prefix`` over a suffix at positions ``prefix_len + i`` that
    attends the prefix's cached K/V too. With ``cache`` given, each
    layer's K/V is written into it in place. ``ffn(layer, h)`` stands in
    for the dense FFN (the MoE model's expert layer), ``ffn_group`` for
    the FFN and its all-reduce (:func:`_stack`); ``attend_fn(q, k, v)``
    for the prompt's attention, or a list of one such a rank (each tp
    rank's own sp ring). Returns (the collectives, the ranks' params,
    the final hidden states (B, S, D) on each rank)."""
    group, ranks = _ranks(params)
    caches = rank_trees(cache, len(ranks))
    prefixes = rank_trees(prefix, len(ranks))
    b, s = tokens.shape
    positions = (prefix_len + torch.arange(s, device=tokens.device)
                 ).expand(b, s)
    if attend_fn is None:
        attend_fn = flash_attention if cfg.use_flash else prefill_attention
    attend_fns = attend_fn if isinstance(attend_fn, list) \
        else [attend_fn] * len(ranks)
    xs = _embed(group, ranks, tokens)
    ropes = _rank_ropes(cfg, xs, positions)

    def attend(r, i, layer, h):
        cos, sin, pos = ropes[r]
        q, k, v = _qkv(layer, h, cfg, cos, sin, pos)
        if prefixes[r] is None:
            attn = attend_fns[r](q, k, v)
        else:
            pk, pv = _prefix_kv(cfg, prefixes[r], i)
            suffix_attend = _flash_suffix if cfg.use_flash \
                else prefix_prefill_attention
            attn = suffix_attend(q, torch.cat([pk, k], dim=1),
                                 torch.cat([pv, v], dim=1), prefix_len)
        if caches[r] is not None:
            for name, rows in _kv_rows(cfg, k, v).items():
                caches[r][name][i, :, :s] = rows
        return attn.reshape(b, s, -1)

    return group, ranks, _stack(group, ranks, xs, cfg, attend, ffn,
                                ffn_group)


def _run_prompt(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                prefix: Optional[Dict[str, torch.Tensor]] = None,
                prefix_len: int = 0, ffn=None) -> torch.Tensor:
    """:func:`_prompt_stack`'s final hidden states (B, S, D) of an
    unsharded model."""
    return _prompt_stack(params, cfg, tokens, cache, prefix, prefix_len,
                         ffn)[2][0]


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            mesh=None, sp_axis: str = "sp", dp_axis: str = "dp",
            tp_axis: str = "tp") -> torch.Tensor:
    """Full causal forward → logits (B, S, V) in float32: the training and
    eval path. Attention is the plain causal ``prefill_attention``, which
    autograd differentiates, or with ``cfg.use_flash`` the flash kernel
    wrapper (forward only on the card: the kernel refuses a gradient).
    With ``mesh`` given (long-context sequence parallelism), attention
    runs as ring attention over the ``sp_axis`` ring
    (``parallel/ring_attention``), its batch on ``dp_axis`` and heads on
    ``tp_axis`` where the mesh has them. ``params`` may be a
    :class:`TPShards` (the tensor-parallel forward), or a tree of
    ``parallel/sharding.Sharded`` leaves over a mesh (the train and eval
    steps': :func:`_mesh_rows`), whose ring, with ``mesh`` given, runs
    over the leaves' own mesh."""
    if mesh is not None:
        _check_mesh(mesh, "llama.forward")
    if _sharded(params):
        rows = _mesh_rows(params, cfg, tokens, mesh is not None, sp_axis,
                         dp_axis, tp_axis)
        home = tokens.device
        return torch.cat([_logits(group, ranks, xs, cfg).to(home)
                          for group, ranks, xs in rows], dim=0)
    attend_fn = None
    if mesh is not None:
        from gofr_tpu_torch.parallel.ring_attention import ring_attention

        def attend_fn(q, k, v):
            return ring_attention(
                q, k, v, mesh, axis_name=sp_axis,
                batch_axis=dp_axis if dp_axis in mesh.shape else None,
                head_axis=tp_axis if tp_axis in mesh.shape else None)
    group, ranks, xs = _prompt_stack(params, cfg, tokens,
                                     attend_fn=attend_fn)
    return _logits(group, ranks, xs, cfg)


def _check_mesh(mesh, owner: str) -> None:
    from gofr_tpu_torch.parallel.mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise ValueError(f"{owner}: mesh must be a gofr_tpu_torch."
                         f"parallel.mesh.Mesh, got {type(mesh).__name__}")


def _sharded(params) -> bool:
    from gofr_tpu_torch.parallel.sharding import is_sharded
    return not isinstance(params, TPShards) and is_sharded(params)


def _mesh_rows(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
               ring: bool = False, sp_axis: str = "sp", dp_axis: str = "dp",
               tp_axis: str = "tp"):
    """The forward over a tree of ``Sharded`` leaves (``parallel/
    sharding.llama_param_specs``, pruned to their mesh), as GSPMD runs
    JAX's under a batch sharded on dp: for each dp coordinate d, its
    rows of ``tokens`` (B / dp of them) through the :class:`TPShards` of
    its tp line (each rank's local tree at coordinate d, every other
    axis 0), one all-reduce after ``wo`` and one after ``w_down``. With
    ``ring``, each (d, tp rank) coordinate attends through its own ring
    over the ``sp_axis`` coordinates' devices (``ring_line``: the
    rank's heads, the sequence cut in sp blocks); the GEMMs of the line
    run at sp coordinate 0 over the row block's whole sequence. Yields
    (collectives, ranks, final hidden states) a dp row, in dp order.

    Coordinates of other axes hold replicas and compute nothing:
    sharing a device they share the tensors, so autograd sums every
    row's gradient into one (JAX's psum over dp); on distinct devices
    the copies' gradients are summed by ``sharding.sum_replicas``."""
    from gofr_tpu_torch.parallel.collectives import Group
    from gofr_tpu_torch.parallel.ring_attention import ring_line
    from gofr_tpu_torch.parallel.sharding import local_tree, mesh_of

    mesh = mesh_of(params)
    names = mesh.axis_names
    n_dp = mesh.shape.get(dp_axis, 1)
    if tokens.shape[0] % n_dp:
        raise ValueError(f"batch {tokens.shape[0]} does not divide over "
                         f"{dp_axis} {n_dp}")
    rows = tokens.shape[0] // n_dp
    lines = [line for line in mesh.axis_coords(tp_axis)
             if not any(c for a, c in zip(names, line[0])
                        if a not in (dp_axis, tp_axis))]
    for d, line in enumerate(lines):
        ranks = TPShards([local_tree(params, c) for c in line],
                         Group([mesh.devices[c] for c in line]))
        attend_fn = None
        if ring:
            at = names.index(sp_axis) if sp_axis in names else None
            n_sp = mesh.shape[sp_axis] if at is not None else 1
            attend_fn = []
            for c in line:
                ring_devs = [mesh.devices[c if at is None else
                                          c[:at] + (s,) + c[at + 1:]]
                             for s in range(n_sp)]
                attend_fn.append(lambda q, k, v, devs=ring_devs:
                                 ring_line(q, k, v, devs))
        block = tokens[d * rows:(d + 1) * rows].to(mesh.devices[line[0]])
        yield _prompt_stack(ranks, cfg, block, attend_fn=attend_fn)


def loss_fn(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            targets: torch.Tensor, mesh=None) -> torch.Tensor:
    """Next-token cross-entropy: the mean over (B, S) of the negative
    log-likelihood of ``targets`` under float32 ``log_softmax`` of
    :func:`forward`'s logits (JAX ``loss_fn``), a float32 scalar.
    ``mesh``: :func:`forward`'s ring attention over its sp axis. Over
    ``Sharded`` params each dp row's NLL is taken on its own rows and
    the rows' NLLs are gathered, then averaged once: the mean over the
    whole global batch, as JAX's."""
    if _sharded(params):
        home = tokens.device
        targets = torch.as_tensor(targets, device=home)
        if mesh is not None:
            _check_mesh(mesh, "llama.loss_fn")
        rows = _mesh_rows(params, cfg, tokens, mesh is not None)
        nlls, at = [], 0
        for group, ranks, xs in rows:
            logits = _logits(group, ranks, xs, cfg)
            n = logits.shape[0]
            nlls.append(token_nll(logits, targets[at:at + n].to(
                logits.device)).to(home))
            at += n
        return torch.cat(nlls, dim=0).mean()
    return mean_nll(forward(params, cfg, tokens, mesh=mesh), targets)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The negative log-likelihood of each of ``targets`` (B, S) under
    float32 ``log_softmax`` of ``logits`` (B, S, V)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def mean_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` (B, S) under float32
    ``log_softmax`` of ``logits`` (B, S, V)."""
    return token_nll(logits, targets).mean()


def prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor],
            lengths: Optional[torch.Tensor] = None,
            prefix: Optional[Dict[str, torch.Tensor]] = None,
            prefix_len: int = 0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """Run the prompt and fill ``cache`` (L, B, T >= S, Hkv, D) in place
    (quantised, with its scale planes, under ``cfg.kv_int8``).
    Returns (last-token logits (B, V) f32, cache, cache_len (B,) int32).

    ``lengths`` (B,) supports right-padded prompts: logits are taken at
    position ``lengths - 1`` of each row and cache_len = lengths.

    ``prefix``/``prefix_len`` is the suffix-only prefill of prefix KV
    reuse (``tpu/prefix_cache``): ``prefix`` holds the K/V of the prompt's
    first ``prefix_len`` tokens (the cache's leaves, shapes (L, B,
    prefix_len, ...); int8 with its scale planes under ``cfg.kv_int8``,
    dequantised to ``cfg.dtype`` here) and ``tokens`` only the suffix.
    RoPE positions are offset by ``prefix_len``, each suffix token attends
    the prefix and causally the suffix, ``cache`` receives the suffix's
    K/V alone (the caller places the prefix) and cache_len counts prefix
    and suffix. With ``cfg.use_flash`` the suffix rows go through the
    flash kernel over zero queries in the prefix's place
    (:func:`_flash_suffix`), so a bf16 prefix gives the full prefill's
    bits for them, given GEMMs whose rows do not depend on the row count
    (the engine's minimum of prefill rows); JAX takes the mask form there
    (``prefix_prefill_attention``, this function without
    ``cfg.use_flash``), whose last bits differ from its flash prefill's.
    With an int8 prefix the logits drift from a full prefill's by the
    quantisation (JAX's contract: token identity holds for bf16 caches).

    With :class:`TPShards` params, ``cache`` and ``prefix`` are the
    ranks' trees (each rank's kv heads) and the logits are rank 0's.
    """
    return _prefill(params, cfg, tokens, cache, lengths, prefix, prefix_len)


def _prefill(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
             cache: Dict[str, torch.Tensor],
             lengths: Optional[torch.Tensor] = None,
             prefix: Optional[Dict[str, torch.Tensor]] = None,
             prefix_len: int = 0, ffn=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """:func:`prefill` with ``ffn(layer, h)`` in the dense FFN's place."""
    b, s = tokens.shape
    dev = tokens.device
    group, ranks, xs = _prompt_stack(params, cfg, tokens, cache, prefix,
                                     prefix_len, ffn)
    if lengths is None:
        lasts = [x[:, -1] for x in xs]
        cache_len = torch.full((b,), prefix_len + s, dtype=torch.int32,
                               device=dev)
    else:
        lengths = lengths.to(dev)
        lasts = [x[torch.arange(b, device=x.device),
                   lengths.long().to(x.device) - 1] for x in xs]
        cache_len = (prefix_len + lengths).to(torch.int32)
    return _logits(group, ranks, lasts, cfg), cache, cache_len


def decode_step_paged(params: Params, cfg: LlamaConfig, token: torch.Tensor,
                      pool: Dict[str, torch.Tensor],
                      page_table: torch.Tensor, cache_len: torch.Tensor,
                      active: torch.Tensor, ragged: bool = True
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

    ``ragged=False`` (the engine's ``ragged_attn="off"``) attends through
    the gather formulation instead (``ops/attention.
    paged_decode_attention``: each slot's pages gathered into a dense
    view, then dense attention; JAX ``ragged=False``), over whatever
    table width the caller passes. The port's default is the ragged
    route. With :class:`TPShards` params ``pool`` is the ranks' trees:
    each rank attends its kv heads through one page table.
    """
    group, ranks = _ranks(params)
    pools = rank_trees(pool, len(ranks))
    b = token.shape[0]
    num_pages, page = pools[0]["k"].shape[1] - 1, pools[0]["k"].shape[2]
    attend_fn = ragged_paged_decode_attention if ragged \
        else paged_decode_attention
    # the append destination is the same for every layer: hoist it.
    # take_along_axis(mode="clip") in JAX: clamp the column explicitly
    page_col = (cache_len.long() // page).clamp(0, page_table.shape[1] - 1)
    page_row = page_table.long().gather(1, page_col[:, None])[:, 0]
    keep = active & (page_row < num_pages)
    dest = (torch.where(keep, page_row, num_pages),
            torch.where(keep, cache_len.long() % page, 0))
    xs = [e[:, None, :] for e in _embed(group, ranks, token)]  # (B, 1, D)
    ropes = _rank_ropes(cfg, xs, cache_len.long()[:, None])
    per = [(table, lens, row, off) for table, lens, row, off in zip(
        group.broadcast(page_table), group.broadcast(cache_len),
        *(group.broadcast(t) for t in dest))]

    def attend(r, i, layer, h):
        cos, sin, pos = ropes[r]
        table, lens, dest_row, dest_off = per[r]
        p = pools[r]
        q, k, v = _qkv(layer, h, cfg, cos, sin, pos)
        k_new, v_new = k[:, 0].contiguous(), v[:, 0].contiguous()
        attn = attend_fn(
            q.contiguous(), p["k"][i][:num_pages], p["v"][i][:num_pages],
            table, k_new, v_new, lens, *_scale_planes(cfg, p, i, num_pages))
        # in-place append into the shared pool (dropped rows: scratch)
        for name, rows in _kv_rows(cfg, k_new, v_new).items():
            p[name][i][dest_row, dest_off] = rows
        return attn.reshape(b, 1, -1)

    xs = _stack(group, ranks, xs, cfg, attend)
    logits = _logits(group, ranks, [x[:, 0] for x in xs], cfg)
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
    Returns (logits (B, V) f32, cache, cache_len + 1). With
    :class:`TPShards` params ``cache`` is the ranks' trees.
    """
    return _decode(params, cfg, token, cache, cache_len, window, table)


def _decode(params: Params, cfg: LlamaConfig, token: torch.Tensor,
            cache: Dict[str, torch.Tensor], cache_len: torch.Tensor,
            window: Optional[int] = None,
            table: Optional[torch.Tensor] = None, ffn=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """:func:`decode_step` with ``ffn(layer, h)`` in the dense FFN's
    place."""
    group, ranks = _ranks(params)
    caches = rank_trees(cache, len(ranks))
    b = token.shape[0]
    t_max = caches[0]["k"].shape[2]
    w = window or t_max
    page = dense_page(t_max, window)
    if table is None and not cfg.use_flash_decode:
        table = identity_table(b, t_max, window, device=token.device)
    xs = [e[:, None, :] for e in _embed(group, ranks, token)]  # (B, 1, D)
    ropes = _rank_ropes(cfg, xs, cache_len.long()[:, None])
    lens = group.broadcast(cache_len)
    tables = group.broadcast(table) if table is not None \
        else [None] * len(ranks)
    # the write destinations are the same for every layer: hoist them
    plans = [_dense_plan(n, 1, t_max) for n in lens]

    def attend(r, i, layer, h):
        cos, sin, pos = ropes[r]
        c = caches[r]
        q, k, v = _qkv(layer, h, cfg, cos, sin, pos)
        k_new, v_new = k[:, 0].contiguous(), v[:, 0].contiguous()
        if cfg.use_flash_decode:
            attn = flash_decode_attention(
                q.contiguous(), c["k"][i][:, :w], c["v"][i][:, :w],
                k_new, v_new, lens[r])
        else:
            k_pages, v_pages, k_scales, v_scales = _dense_pool(cfg, c, i,
                                                               page)
            attn = ragged_paged_decode_attention(
                q.contiguous(), k_pages, v_pages, tables[r], k_new, v_new,
                lens[r], k_scales, v_scales)
        for name, rows in _kv_rows(cfg, k_new, v_new).items():
            _dense_write(c[name][i], rows[:, None], plans[r])
        return attn.reshape(b, 1, -1)

    xs = _stack(group, ranks, xs, cfg, attend, ffn)
    logits = _logits(group, ranks, [x[:, 0] for x in xs], cfg)
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

    def attend(r, i, layer, h):
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k, v = k.contiguous(), v.contiguous()
        k_pages, v_pages, k_scales, v_scales = _dense_pool(cfg, cache, i,
                                                           page)
        attn = ragged_paged_verify_attention(
            q.contiguous(), k_pages, v_pages, table, k, v, cache_len,
            k_scales, v_scales)
        for name, rows in _kv_rows(cfg, k, v).items():
            _dense_write(cache[name][i], rows, plan)
        return attn.reshape(b, g_len, -1)

    group, ranks = _ranks(params)
    xs = _stack(group, ranks, [params["tok_emb"][tokens]], cfg, attend)
    return _logits(group, ranks, xs, cfg), cache


def verify_step_paged(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
                      pool: Dict[str, torch.Tensor],
                      page_table: torch.Tensor, cache_len: torch.Tensor,
                      active: torch.Tensor, ragged: bool = True
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
    prefix. ``ragged=False``: the gather formulation
    (``ops/attention.paged_verify_attention``), as in
    :func:`decode_step_paged`.
    """
    b, g_len = tokens.shape
    dev = tokens.device
    cos, sin = _rope(cfg, dev)
    positions = cache_len.long()[:, None] \
        + torch.arange(g_len, device=dev)[None, :]          # (B, G)
    num_pages, page = pool["k"].shape[1] - 1, pool["k"].shape[2]
    attend_fn = ragged_paged_verify_attention if ragged \
        else paged_verify_attention
    width = page_table.shape[1]
    # the write destinations are the same for every layer: hoist them
    page_col = positions // page
    page_row = page_table.long().gather(1, page_col.clamp(max=width - 1))
    keep = active[:, None] & (page_col < width) & (page_row < num_pages)
    dest_row = torch.where(keep, page_row, num_pages)
    dest_off = torch.where(keep, positions % page, 0)

    def attend(r, i, layer, h):
        q, k, v = _qkv(layer, h, cfg, cos, sin, positions)
        k, v = k.contiguous(), v.contiguous()
        attn = attend_fn(
            q.contiguous(), pool["k"][i][:num_pages],
            pool["v"][i][:num_pages], page_table, k, v, cache_len,
            *_scale_planes(cfg, pool, i, num_pages))
        for name, rows in _kv_rows(cfg, k, v).items():
            pool[name][i][dest_row, dest_off] = rows
        return attn.reshape(b, g_len, -1)

    group, ranks = _ranks(params)
    xs = _stack(group, ranks, [params["tok_emb"][tokens]], cfg, attend)
    return _logits(group, ranks, xs, cfg), pool


def generate(params: Params, cfg: LlamaConfig, tokens: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy (or temperature) generation (JAX ``generate``): prefill into
    a dense cache of ``min(max_seq_len, S + max_new_tokens)`` positions,
    then ``max_new_tokens - 1`` decode steps. ``rng`` is a threefry key
    ((2,) words, ``ops/prng``; None: ``PRNGKey(0)``), split once into
    ``max_new_tokens`` keys, the first for the prefill's sample, as JAX
    does; a sampled step draws ``argmax(gumbel(key, (B, V)) + logits /
    temperature)`` (``jax.random.categorical`` with one key for the
    batch). Returns (B, max_new_tokens) int32."""
    b, s = tokens.shape
    dev = tokens.device
    cache = init_cache(cfg, b, min(cfg.max_seq_len, s + max_new_tokens),
                       device=dev)
    logits, cache, cache_len = prefill(params, cfg, tokens, cache)
    if rng is None:
        rng = prng.seed_key(torch.zeros((), dtype=torch.int64, device=dev))
    keys = prng.split(rng.to(dev), max_new_tokens)

    def sample(logits, key):
        if temperature > 0.0:
            scaled = logits / temperature
            noise = prng.gumbel(key, tuple(scaled.shape))
            return torch.argmax(noise + scaled, dim=-1)
        return logits.argmax(dim=-1)

    token = sample(logits, keys[0])
    out = [token]
    for i in range(1, max_new_tokens):
        logits, cache, cache_len = decode_step(params, cfg, token, cache,
                                               cache_len)
        token = sample(logits, keys[i])
        out.append(token)
    return torch.stack(out, dim=1).to(torch.int32)
