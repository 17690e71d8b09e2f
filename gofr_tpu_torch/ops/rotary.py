"""Rotary position embeddings (counterpart of ``gofr_tpu/ops/rotary.py``).

The cos/sin tables are built once per maximum length in float32; absolute
positions index them, so one function serves prefill (0..S-1) and decode
(cache_len). The rotation runs in float32 and is cast back.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def rope_table(max_len: int, head_dim: int, theta: float = 10000.0,
               device: Union[str, torch.device] = "cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_len, head_dim/2) float32 cos and sin tables."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    positions = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(positions, inv_freq)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (batch, seq, heads, head_dim) by the rotate-half rule.
    ``positions`` is (batch, seq) integer absolute positions."""
    cos_g = cos[positions][:, :, None, :]
    sin_g = sin[positions][:, :, None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos_g - x2 * sin_g, x2 * cos_g + x1 * sin_g],
                        dim=-1)
    return rotated.to(x.dtype)
