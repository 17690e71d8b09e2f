"""Int8 helpers (counterpart of ``qmm`` and ``quantize_kv`` in
``gofr_tpu/ops/quant.py``).

- ``qmm``: weights are plain tensors ``(in, out)`` or the ``{"q": int8
  (in, out), "s": (1, out)}`` dict form. Eager PyTorch materialises the
  converted weight on every call (XLA fused the convert into the matmul);
  int8 weights are not on a served path yet.
- ``quantize_kv``: the int8 KV cache's per-(token, head) quantiser, on
  every pool write of a ``kv_int8`` model.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` over a plain weight or an int8 quant dict."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


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
