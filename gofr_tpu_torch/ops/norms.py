"""Normalisation ops (counterpart of ``gofr_tpu/ops/norms.py``).

Statistics accumulate in float32 whatever the activation type, and the
result is cast back to the input's type so the neighbouring matmuls stay
in bf16.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama family). float32 statistics, cast back to x.dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * (1.0 / torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm (BERT family). float32 statistics, cast back to x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    normed = (x32 - mean) * (1.0 / torch.sqrt(var + eps))
    return (normed * weight.float() + bias.float()).to(x.dtype)
