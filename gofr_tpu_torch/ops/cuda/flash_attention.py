"""Flash attention for prefill: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``gofr_tpu/ops/pallas/flash_attention.py``).

The kernel (``gofr_tpu_torch/csrc/flash_attention.cu``) replaces the
Pallas ``_flash_kernel``. A CPU tensor takes :func:`flash_attention_plain`;
a CUDA tensor launches the kernel or raises — no shape-based fallback.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops import attention as plain_attention
from gofr_tpu_torch.ops.cuda import _build

NAME = "flash_attention"
SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (not counting plain-version calls)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch: ``prefill_attention`` when
    causal, unmasked ``attention`` otherwise."""
    if causal:
        return plain_attention.prefill_attention(q, k, v)
    return plain_attention.attention(q, k, v)


def _bind(lib: ctypes.CDLL):
    fn = lib.gofr_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: q (B,S,Hq,D) and k/v (B,S,Hkv,D) expected, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError("flash_attention: q and k/v disagree on B, S or D")
    if hq % k.shape[2]:
        raise ValueError("flash_attention: Hq must be a multiple of Hkv")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(bf16 or f32, the same for q, k and v)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if b * hq > 65535:
        raise ValueError("flash_attention: B * Hq exceeds the grid limit")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Causal (or full) attention. q (B,S,Hq,D), k/v (B,S,Hkv,D) ->
    (B,S,Hq,D) in q's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    _build.refuse_autograd(NAME, q, k, v)
    global launches
    fn = _bind(_build.load(NAME))
    out = torch.empty_like(q)
    b, s, hq, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, hq, k.shape[2], d, int(causal), _DTYPE_CODES[q.dtype],
             _build.stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
