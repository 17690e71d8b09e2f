"""Dense flash decode attention: the CUDA kernel's wrapper and its plain
PyTorch version (counterpart of ``gofr_tpu/ops/pallas/decode_attention.py``).

The kernel (``gofr_tpu_torch/csrc/decode_attention.cu``) replaces the
Pallas ``_decode_kernel``, which the speculative draft model runs on every
decode step (``llama.decode_step``). Its numerics are that kernel's, not
the ``_snap`` oracle's (``decode_attention_cached``): float32 online
softmax over blocks of 128 positions, q scaled before the dot, no
intermediate rounding, the new token folded in last, the output cast
once. A CPU tensor takes :func:`flash_decode_attention_plain`; a CUDA
tensor launches the kernel or raises — no shape-based fallback.

The kernel splits the positions across blocks (:func:`split_plan`): each
chunk's float32 partial (m, l, acc) goes to scratch that the wrapper
allocates, and a combine folds them in chunk order. One call counts one
launch.
"""

from __future__ import annotations

import ctypes

import torch

from gofr_tpu_torch.ops.cuda import _build

NAME = "decode_attention"
HEAD_DIM = 128
SUPPORTED_GROUPS = (1, 2, 4, 8)
BLOCK_K = 128
CHUNK = 256          # positions a block walks, by default
MAX_SPLITS = 16      # chunks the combine folds (the kernel's bound)
_NEG_INF = -1e30

# kernel launches since the last reset (not counting plain-version calls)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_decode_attention_plain(q, k_cache, v_cache, k_new, v_new,
                                 cache_len) -> torch.Tensor:
    """The same function in plain PyTorch, step for step as the Pallas
    kernel: per block of ``BLOCK_K`` positions that holds a live entry,
    scores of the pre-scaled query (positions at or past ``cache_len``
    masked), running max / normaliser / P·V with the correction factor;
    then the new token; then ``acc / max(l, 1e-30)``. Blocks wholly past
    a row's fill leave its state untouched (the kernel never visits
    them), and V rows past the fill are zeroed so a NaN there cannot
    reach the output through ``0 * NaN``.

    q: (B, 1, Hq, D); caches: (B, T, Hkv, D); k_new/v_new: (B, Hkv, D);
    cache_len: (B,) valid entries excluding the new token.
    Returns (B, 1, Hq, D) in q's type."""
    batch, _, q_heads, head_dim = q.shape
    t_max, kv_heads = k_cache.shape[1], k_cache.shape[2]
    group = q_heads // kv_heads
    dev = q.device
    lens = cache_len.to(dev).long()
    qs = q[:, 0].float().reshape(batch, kv_heads, group, head_dim) \
        * head_dim ** -0.5
    m = torch.full((batch, kv_heads, group, 1), _NEG_INF, device=dev)
    l = torch.zeros((batch, kv_heads, group, 1), device=dev)
    acc = torch.zeros((batch, kv_heads, group, head_dim), device=dev)
    for start in range(0, t_max, BLOCK_K):
        stop = min(start + BLOCK_K, t_max)
        pos = torch.arange(start, stop, device=dev)
        live = pos[None, :] < lens[:, None]                     # (B, bk)
        k_blk = k_cache[:, start:stop].float()
        v_blk = torch.where(live[:, :, None, None],
                            v_cache[:, start:stop].float(), 0.0)
        scores = torch.einsum("bkgd,btkd->bkgt", qs, k_blk)
        scores = torch.where(live[:, None, None, :], scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        visit = (start < lens)[:, None, None, None]             # (B,1,1,1)
        l = torch.where(visit, l * corr + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(visit, acc * corr
                          + torch.einsum("bkgt,btkd->bkgd", p, v_blk), acc)
        m = torch.where(visit, m_new, m)
    s_new = (qs * k_new.float()[:, :, None, :]).sum(-1, keepdim=True)
    m_fin = torch.maximum(m, s_new)
    corr = torch.exp(m - m_fin)
    p_new = torch.exp(s_new - m_fin)
    l_fin = l * corr + p_new
    acc = acc * corr + p_new * v_new.float()[:, :, None, :]
    out = acc / torch.clamp_min(l_fin, 1e-30)
    return out.reshape(batch, 1, q_heads, head_dim).to(q.dtype)


def split_plan(t_max: int) -> tuple:
    """(chunk, splits) for a cache of static width ``t_max``: chunks are
    whole blocks of ``BLOCK_K`` positions, ``CHUNK`` long unless more
    than ``MAX_SPLITS`` of them would be needed, and ``splits`` chunks
    cover ``t_max``. Depends on the width alone, never on the fills, so
    the host reads nothing from the card."""
    if t_max <= 0:
        raise ValueError(f"flash_decode_attention: T must be positive, "
                         f"got {t_max}")
    blocks = -(-t_max // BLOCK_K)
    per_chunk = max(CHUNK // BLOCK_K, -(-blocks // MAX_SPLITS))
    chunk = per_chunk * BLOCK_K
    return chunk, -(-t_max // chunk)


def scratch_shape(batch: int, t_max: int, kv_heads: int,
                  group: int) -> tuple:
    """The float32 scratch of one call: per slot, KV head, chunk and
    query row of the group, ``HEAD_DIM`` accumulator values, then m and
    l."""
    return (batch, kv_heads, split_plan(t_max)[1], group, HEAD_DIM + 2)


def _bind(lib: ctypes.CDLL):
    fn = lib.gofr_flash_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _window_view(cache) -> bool:
    """Whether ``cache`` (B, T, Hkv, D) is contiguous in its last three
    dims with a slot stride of whole positions: a contiguous cache, or its
    first T positions (``cache[:, :T]``, an attention window)."""
    _, t_max, hkv, d = cache.shape
    pos = hkv * d
    return (cache.stride(3) == 1 and cache.stride(2) == d
            and cache.stride(1) == pos and cache.stride(0) % pos == 0
            and cache.stride(0) // pos >= t_max)


def _check(q, k_cache, v_cache, k_new, v_new, cache_len) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_attention: q (B,1,Hq,D) expected, "
                         f"got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != b:
        raise ValueError("flash_decode_attention: k/v caches (B,T,Hkv,D) "
                         "expected")
    hkv = k_cache.shape[2]
    if d != HEAD_DIM or k_cache.shape[3] != d:
        raise ValueError(f"flash_decode_attention: head_dim must be "
                         f"{HEAD_DIM}, got {d}")
    if hq % hkv or hq // hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"flash_decode_attention: group Hq/Hkv must be "
                         f"one of {SUPPORTED_GROUPS}")
    if tuple(k_new.shape) != (b, hkv, d) or v_new.shape != k_new.shape:
        raise ValueError("flash_decode_attention: k_new/v_new (B,Hkv,D) "
                         "expected")
    if tuple(cache_len.shape) != (b,) or cache_len.dtype != torch.int32:
        raise ValueError("flash_decode_attention: cache_len (B,) int32 "
                         "expected")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_decode_attention: {name} must be bf16, "
                             f"got {t.dtype}")
    tensors = (q, k_cache, v_cache, k_new, v_new, cache_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_decode_attention: tensors on different "
                         "devices")
    if not all(t.is_contiguous() for t in (q, k_new, v_new, cache_len)):
        raise ValueError("flash_decode_attention: q, k_new, v_new and "
                         "cache_len must be contiguous")
    if k_cache.stride() != v_cache.stride() or not _window_view(k_cache):
        raise ValueError("flash_decode_attention: k/v caches must be "
                         "contiguous, or the first T positions of a "
                         "contiguous (B, T_full, Hkv, D) cache, both alike")
    # the kernel reads 16-byte vectors of bf16
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache, k_new, v_new)):
        raise ValueError("flash_decode_attention: bf16 operands must be "
                         "16-byte aligned")


def flash_decode_attention(q, k_cache, v_cache, k_new, v_new,
                           cache_len) -> torch.Tensor:
    """Decode attention over a dense cache plus the new token's K/V.
    q (B,1,Hq,D); caches (B,T,Hkv,D), contiguous or the first T positions
    of a longer cache (an attention window's view ``cache[:, :T]``: the
    kernel steps slot to slot by the full cache's stride, and the split
    plan follows T); k_new/v_new (B,Hkv,D); cache_len (B,) int32 valid
    entries excluding the new token. Returns (B,1,Hq,D)."""
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, k_new,
                                            v_new, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
    _check(q, k_cache, v_cache, k_new, v_new, cache_len)
    global launches
    fn = _bind(_build.load(NAME))
    out = torch.empty_like(q)
    b, _, hq, d = q.shape
    t_max, hkv = k_cache.shape[1], k_cache.shape[2]
    chunk, splits = split_plan(t_max)
    scratch = torch.empty(scratch_shape(b, t_max, hkv, hq // hkv),
                          dtype=torch.float32, device=q.device)
    slot_t = k_cache.stride(0) // (hkv * d)        # the full cache's T
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             k_new.data_ptr(), v_new.data_ptr(), cache_len.data_ptr(),
             out.data_ptr(), scratch.data_ptr(), b, t_max, slot_t, hq, hkv,
             d, chunk, splits, _build.stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"flash_decode_attention: kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    return out
