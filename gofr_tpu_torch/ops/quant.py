"""Weight-only int8 matmul (counterpart of ``qmm`` in
``gofr_tpu/ops/quant.py``).

Only ``qmm`` is on the slice's path: weights are plain tensors
``(in, out)`` or the ``{"q": int8 (in, out), "s": (1, out)}`` dict form.
Eager PyTorch materialises the converted weight on every call (XLA fused
the convert into the matmul); the int8 path is not on the main path yet.
"""

from __future__ import annotations

from typing import Any

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def qmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` over a plain weight or an int8 quant dict."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w
