"""BERT-base encoder for the streaming-embeddings path (counterpart of
``gofr_tpu/models/bert.py``).

Params in JAX's layout: per-layer weights stacked on a leading (L, ...)
axis, linears stored (in, out); the layer loop is a Python loop over
views of the stacks. Matmuls in the config's dtype, LayerNorm
(eps 1e-12) and softmax in float32, GELU JAX's default tanh
approximation in float32, cast back. Attention is the plain
``ops.attention`` under a (B, 1, 1, 1, T) key mask, as JAX's; a padding
row (an all-zero mask) attends uniformly over its positions as JAX's
does, and its masked mean is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from gofr_tpu_torch.device import resolve_device
from gofr_tpu_torch.ops.attention import attention
from gofr_tpu_torch.ops.norms import layer_norm

__all__ = ["BertConfig", "PRESETS", "apply", "config", "init"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    norm_eps: float = 1e-12
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


PRESETS = {
    "tiny": BertConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                       ffn_dim=128, max_len=64),
    "base": BertConfig(),
}


def config(preset: str = "base", **overrides) -> BertConfig:
    return dataclasses.replace(PRESETS[preset], **overrides)


def init(cfg: BertConfig, seed: int = 0,
         device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Random params drawn on ``device`` from a seeded generator: normal
    with std 1/sqrt(fan_in), LayerNorms at identity, zero biases."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    dt = cfg.dtype
    d, f, n = cfg.dim, cfg.ffn_dim, cfg.n_layers

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * (1.0 / math.sqrt(fan_in))).to(dt)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "tok_emb": dense((cfg.vocab_size, d), d),
        "pos_emb": dense((cfg.max_len, d), d),
        "type_emb": dense((cfg.type_vocab, d), d),
        "emb_norm_w": full((d,), 1.0),
        "emb_norm_b": full((d,), 0.0),
        "layers": {
            "wq": dense((n, d, d), d), "wk": dense((n, d, d), d),
            "wv": dense((n, d, d), d), "wo": dense((n, d, d), d),
            "bq": full((n, d), 0.0), "bk": full((n, d), 0.0),
            "bv": full((n, d), 0.0), "bo": full((n, d), 0.0),
            "attn_norm_w": full((n, d), 1.0),
            "attn_norm_b": full((n, d), 0.0),
            "w_in": dense((n, d, f), d), "b_in": full((n, f), 0.0),
            "w_out": dense((n, f, d), f), "b_out": full((n, d), 0.0),
            "ffn_norm_w": full((n, d), 1.0),
            "ffn_norm_b": full((n, d), 0.0),
        },
        "pool_w": dense((d, d), d),
        "pool_b": full((d,), 0.0),
    }


def _embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, table.shape[-1])


def apply(params: Dict[str, Any], cfg: BertConfig, token_ids: torch.Tensor,
          attention_mask: Optional[torch.Tensor] = None,
          type_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """token_ids (B, S) int -> {"sequence": (B, S, D), "pooled": (B, D),
    "mean": (B, D)}; ``mean`` is the masked mean-pooled embedding in
    float32."""
    b, s = token_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32,
                                    device=token_ids.device)
    if type_ids is None:
        type_ids = torch.zeros_like(token_ids)
    x = (_embed(params["tok_emb"], token_ids)
         + params["pos_emb"][None, :s]
         + _embed(params["type_emb"], type_ids))
    x = layer_norm(x, params["emb_norm_w"], params["emb_norm_b"],
                   cfg.norm_eps)
    # (B, 1, 1, 1, T): ops.attention's grouped-score layout
    mask = attention_mask[:, None, None, None, :].bool()
    layers = params["layers"]
    for i in range(cfg.n_layers):
        def proj(w, bias):
            return (x @ layers[w][i] + layers[bias][i]).reshape(
                b, s, cfg.n_heads, cfg.head_dim)
        attn = attention(proj("wq", "bq"), proj("wk", "bk"),
                         proj("wv", "bv"), mask).reshape(b, s, -1)
        x = layer_norm(x + attn @ layers["wo"][i] + layers["bo"][i],
                       layers["attn_norm_w"][i], layers["attn_norm_b"][i],
                       cfg.norm_eps)
        h = F.gelu((x @ layers["w_in"][i] + layers["b_in"][i]).float(),
                   approximate="tanh").to(x.dtype)
        x = layer_norm(x + h @ layers["w_out"][i] + layers["b_out"][i],
                       layers["ffn_norm_w"][i], layers["ffn_norm_b"][i],
                       cfg.norm_eps)
    pooled = torch.tanh((x[:, 0] @ params["pool_w"] + params["pool_b"])
                        .float())
    weights = attention_mask.float()[..., None]
    mean = ((x.float() * weights).sum(dim=1)
            / weights.sum(dim=1).clamp_min(1.0))
    return {"sequence": x, "pooled": pooled, "mean": mean}
