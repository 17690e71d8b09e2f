"""Int8 helpers (counterpart of ``gofr_tpu/ops/quant.py``).

- Weight-only int8 (:func:`quantize`, :func:`dequantize`,
  :func:`quantize_tree`): each matmul weight ``(..., in, out)`` becomes
  ``{"q": int8 (..., in, out), "s": float32 (..., 1, out)}``, symmetric
  per output channel, the JAX package's bits.
- ``qmm``: ``x @ w`` over a plain weight or the quant dict. Eager
  PyTorch materialises the converted weight on every call (XLA fused the
  convert into the matmul).
- ``quantize_kv``: the int8 KV cache's per-(token, head) quantiser, on
  every pool write of a ``kv_int8`` model.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

# param names whose matmul weights quantize (llama and moe families)
QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})


def quantize(w: torch.Tensor,
             scale_dtype: torch.dtype = torch.float32) -> dict:
    """Symmetric per-output-channel int8 quantisation of a matmul weight
    ``(..., in, out)`` → ``{"q": int8 (..., in, out), "s": (..., 1, out)}``
    with ``w ≈ q * s``: absmax over axis -2 in float32, ``scale = amax /
    127`` (1 where amax is 0), ``round(w / scale)`` half to even, clamped
    to ±127 (the JAX package's steps, so the two give the same bits)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(scale_dtype)}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` over a plain weight or an int8 quant dict."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def dequantize(w: Any) -> torch.Tensor:
    """A quant dict back to a bf16 weight (``q * s`` in float32); a plain
    weight as it is."""
    if is_quantized(w):
        return (w["q"].float() * w["s"]).to(torch.bfloat16)
    return w


def quantize_tree(params: Any, keys=QUANT_KEYS) -> Any:
    """Quantise every matmul weight named in ``keys`` through a params tree
    (dicts, lists, tuples), leaving norms, embeddings and routers as they
    are."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if name in keys and getattr(node, "ndim", 0) >= 2:
            return quantize(node)
        return node
    return walk(params)


def quantized_specs(specs: Any, params: Any) -> Any:
    """Mirror ``quantize_tree`` over a PartitionSpec tree
    (``parallel/sharding.P``): wherever ``params`` carries a quant dict,
    expand the weight's spec into ``{"q": original, "s": original with
    the in-features axis dropped}`` (the scale's in-dim is size 1 and
    must not be sharded)."""
    from gofr_tpu_torch.parallel.sharding import P

    def expand(spec, param):
        if is_quantized(param):
            ndim = param["q"].ndim
            axes = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
            s_axes = axes[:-2] + (None, axes[-1])
            return {"q": P(*axes), "s": P(*s_axes)}
        if isinstance(param, dict):
            return {k: expand(spec[k] if isinstance(spec, dict) else spec,
                              param[k])
                    for k in param}
        if isinstance(param, (list, tuple)):
            sub = spec if isinstance(spec, (list, tuple)) \
                and not isinstance(spec, P) else [spec] * len(param)
            return type(param)(expand(sp, pa) for sp, pa in zip(sub, param))
        return spec

    return expand(specs, params)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantisation of KV rows: ``(..., D) ->
    (int8 (..., D), float32 scale (...,))`` with ``x ≈ q * scale``.

    The JAX package's steps, in its order, so the two give the same bits:
    amax over the last axis in float32, ``scale = amax / 127`` (1 where
    amax is 0), ``round(x / scale)`` half to even, clamped to ±127."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale
