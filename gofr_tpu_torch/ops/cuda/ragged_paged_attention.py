"""Ragged paged attention: the CUDA kernels' wrappers and their plain
PyTorch versions (counterpart of
``gofr_tpu/ops/pallas/ragged_paged_attention.py``): the decode variant
(one query per slot) and the speculative verify variant (G queries per
slot, causal among the new tokens), over bf16 pools or int8 pools with
their float32 scale planes.

One kernel source (``gofr_tpu_torch/csrc/ragged_paged_attention.cu``)
replaces the Pallas ``_ragged_kernel`` in all its forms, decode being its
G = 1 launch and int8 pools its int8 instantiation (dequantised in the
kernel), with two bodies. At head_dim 128, and at 64 for a verify of more
than ``D64_MAX_ROWS`` query rows a KV head, a cluster of ``CLUSTER``
blocks per (KV head, slot), for all the slot's queries, splits each
slot's live pages into page-aligned chunks (:func:`rank_pages`). At
head_dim 64 otherwise (every decode, verify of group x G <= 8) a cluster
of :func:`d64_ranks` blocks, sized by the table's width, walks the slot's
positions in sweeps of ``D64_SPAN``, rank ``r`` taking sweeps ``r, r +
ranks, ...`` (:func:`d64_rank_sweeps`), so its result depends on the fill
and never on the table's width. Both walk the slot's page-table
row and never read a sentinel or a row past the fill, scale planes
included.
A CPU tensor takes the ``*_plain`` version; a CUDA tensor launches the
kernel or raises — no shape-based fallback, and an int8 pool is never
dequantised to take the bf16 kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gofr_tpu_torch.ops import attention as plain_attention
from gofr_tpu_torch.ops.cuda import _build

NAME = "ragged_paged_attention"
SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)
MAX_VERIFY_TOKENS = 8        # the kernel's MAX_NEW
CLUSTER = 8                  # blocks a (KV head, slot) cluster
MAX_DYN_SMEM = 160 * 1024    # the kernel's MAX_DYN_SMEM
# the head_dim-64 body (the kernel's d64:: constants): positions a
# sweep, blocks a (KV head, slot) at most, query rows a KV head at most
D64_SPAN = 512
D64_MAX_RANKS = 8
D64_MAX_ROWS = 8

# kernel launches since the last reset (not counting plain-version calls):
# ``launches`` counts bf16 decode launches, ``verify_launches`` bf16 verify
# ones, ``int8_launches`` / ``int8_verify_launches`` the same over int8
# pools
launches = 0
verify_launches = 0
int8_launches = 0
int8_verify_launches = 0


def reset_launches() -> None:
    global launches, verify_launches, int8_launches, int8_verify_launches
    launches = verify_launches = 0
    int8_launches = int8_verify_launches = 0


def rank_pages(cache_len: int, page: int,
               cluster: int = CLUSTER) -> list:
    """The kernel's chunk rule, in Python: the page indices (into the
    slot's table row) that each block of a cluster walks, as one ``range``
    per rank. The slot's ``ceil(cache_len / page)`` live pages go out in
    runs of ``ceil(pages / cluster)``, rank order; ranks past the fill get
    an empty range. Rank ``r`` walks the positions of its pages below
    ``cache_len``. For tests: the served path never calls it."""
    pages = -(-max(cache_len, 0) // page)
    per_rank = -(-pages // cluster)
    return [range(min(r * per_rank, pages), min((r + 1) * per_rank, pages))
            for r in range(cluster)]


def d64_body(head_dim: int, group: int, g_len: int) -> bool:
    """Whether a launch takes the head_dim-64 body: head_dim 64 and at
    most ``D64_MAX_ROWS`` query rows (``g_len * group``) a KV head."""
    return head_dim == 64 and g_len * group <= D64_MAX_ROWS


def d64_ranks(table_width: int, page: int) -> int:
    """The head_dim-64 body's blocks a (KV head, slot): one per
    ``D64_SPAN`` positions of the table (``table_width * page``), at
    least 1, at most ``D64_MAX_RANKS``; never from ``cache_len``."""
    sweeps = -(-table_width * page // D64_SPAN)
    return max(1, min(D64_MAX_RANKS, sweeps))


def d64_rank_sweeps(cache_len: int, page: int, table_width: int) -> list:
    """The head_dim-64 body's split, in Python: for each of the
    :func:`d64_ranks` blocks, in rank order, the positions of each sweep
    it walks, in its order: sweep ``k`` is positions ``[k D64_SPAN, (k +
    1) D64_SPAN)`` below the fill (``min(cache_len, table_width *
    page)``), and rank ``r`` takes sweeps ``r, r + ranks, ...``; a rank
    past the fill walks none. For tests: the served path never calls
    it."""
    ranks = d64_ranks(table_width, page)
    fill = max(0, min(cache_len, table_width * page))
    return [[range(start, min(start + D64_SPAN, fill))
             for start in range(r * D64_SPAN, fill, ranks * D64_SPAN)]
            for r in range(ranks)]


def dyn_smem_bytes(table_width: int, page: int, group: int, g_len: int,
                   head_dim: int) -> int:
    """The kernel's dynamic shared memory for ``g_len`` queries a slot, a
    table of ``table_width`` columns and head dim ``head_dim``: for the
    cluster-of-8 body the queries (bf16), one rank's partials and scores
    (float32) and its page ids; the head_dim-64 body (:func:`d64_body`)
    keeps its scores in registers and takes none."""
    if d64_body(head_dim, group, g_len):
        return 0
    per_rank = -(-table_width // CLUSTER)
    rows = g_len * group
    return rows * head_dim * 6 + rows * per_rank * page * 4 + per_rank * 4


def ragged_paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                        k_new, v_new, cache_len,
                                        k_scale_pages=None,
                                        v_scale_pages=None) -> torch.Tensor:
    """The same function in plain PyTorch: the gather formulation
    (``paged_decode_attention``), with sentinel ids clamped and V rows
    (and V scales) at or past ``cache_len`` zeroed, so pages no live
    position references cannot reach the output even when they hold
    NaN."""
    return plain_attention.paged_decode_attention(
        q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
        k_scale_pages, v_scale_pages)


def ragged_paged_verify_attention_plain(q, k_pages, v_pages, page_table,
                                        k_new, v_new, cache_len,
                                        k_scale_pages=None,
                                        v_scale_pages=None) -> torch.Tensor:
    """The verify variant in plain PyTorch: ``paged_verify_attention``
    (gather formulation, sentinels clamped, V rows past the fill zeroed).
    With G = 1 it is bit-identical to the decode plain version."""
    return plain_attention.paged_verify_attention(
        q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
        k_scale_pages, v_scale_pages)


def _bind(lib: ctypes.CDLL, entry: str):
    fn = getattr(lib, entry)
    n_ptrs = 10 if "int8" in entry else 8
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_scales(k_pages, v_pages, k_scale_pages, v_scale_pages) -> bool:
    """Pool element type: bf16 pools without scale planes, or int8 pools
    with both float32 planes (N, page, Hkv). Returns True for int8."""
    if (k_scale_pages is None) != (v_scale_pages is None):
        raise ValueError("ragged_paged_attention: pass both scale planes "
                         "or neither")
    want = torch.bfloat16 if k_scale_pages is None else torch.int8
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != want:
            raise ValueError(
                f"ragged_paged_attention: {name} must be {want} "
                f"{'with' if want == torch.int8 else 'without'} scale "
                f"planes, got {t.dtype}")
    if k_scale_pages is None:
        return False
    for name, t in (("k_scale_pages", k_scale_pages),
                    ("v_scale_pages", v_scale_pages)):
        if tuple(t.shape) != tuple(k_pages.shape[:3]) \
                or t.dtype != torch.float32:
            raise ValueError(
                f"ragged_paged_attention: {name} must be float32 "
                f"{tuple(k_pages.shape[:3])} (N,page,Hkv), got {t.dtype} "
                f"{tuple(t.shape)}")
        if t.device != k_pages.device or not t.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be "
                             f"contiguous, on the pools' device")
    return True


def _check(q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
           k_scale_pages=None, v_scale_pages=None) -> bool:
    """Shapes of the verify form: q (B,G,Hq,D), k_new/v_new (B,G,Hkv,D);
    the decode form reaches here with G = 1. Returns True for int8
    pools."""
    if q.dim() != 4 or not 1 <= q.shape[1] <= MAX_VERIFY_TOKENS:
        raise ValueError(f"ragged_paged_attention: q (B,G,Hq,D) with G in "
                         f"[1, {MAX_VERIFY_TOKENS}] expected, got "
                         f"{tuple(q.shape)}")
    b, g_len, hq, d = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("ragged_paged_attention: k/v pages "
                         "(N,page,Hkv,D) expected")
    hkv = k_pages.shape[2]
    if d not in SUPPORTED_HEAD_DIMS or k_pages.shape[3] != d:
        raise ValueError(f"ragged_paged_attention: head_dim must be one of "
                         f"{SUPPORTED_HEAD_DIMS}, got {d}")
    if hq % hkv or hq // hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"ragged_paged_attention: group Hq/Hkv "
                         f"must be one of {SUPPORTED_GROUPS}")
    if tuple(k_new.shape) != (b, g_len, hkv, d) \
            or v_new.shape != k_new.shape:
        raise ValueError("ragged_paged_attention: k_new/v_new (B,G,Hkv,D) "
                         "expected")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(cache_len.shape) != (b,):
        raise ValueError("ragged_paged_attention: page_table (B,P) "
                         "and cache_len (B,) expected")
    page = k_pages.shape[1]
    if dyn_smem_bytes(page_table.shape[1], page, hq // hkv, g_len,
                      d) > MAX_DYN_SMEM:
        raise ValueError(f"ragged_paged_attention: a block's chunk of "
                         f"{page_table.shape[1]} page-table columns of "
                         f"{page} positions does not fit "
                         f"{MAX_DYN_SMEM} bytes of shared memory")
    int8 = _check_scales(k_pages, v_pages, k_scale_pages, v_scale_pages)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"ragged_paged_attention: {name} must "
                             f"be bf16, got {t.dtype}")
    for name, t in (("page_table", page_table), ("cache_len", cache_len)):
        if t.dtype != torch.int32:
            raise ValueError(f"ragged_paged_attention: {name} must "
                             f"be int32, got {t.dtype}")
    tensors = (q, k_pages, v_pages, page_table, k_new, v_new, cache_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("ragged_paged_attention: tensors on "
                         "different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_paged_attention: every tensor "
                         "must be contiguous")
    # the kernel reads 16-byte vectors of bf16 and 8-byte vectors of int8
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, k_new, v_new)):
        raise ValueError("ragged_paged_attention: q, pools and new K/V "
                         "must be 16-byte aligned")
    return int8


def _launch(q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
            k_scale_pages=None, v_scale_pages=None,
            verify_form: bool = False) -> Tuple[torch.Tensor, bool]:
    """Check, launch the kernel once (the int8 instantiation for int8
    pools), raise on a refused launch. Returns (output, int8)."""
    int8 = _check(q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
                  k_scale_pages, v_scale_pages)
    _build.refuse_autograd(NAME, q, k_pages, v_pages, k_new, v_new,
                           k_scale_pages, v_scale_pages)
    entry = "gofr_ragged_paged_attention" + ("_int8" if int8 else "") \
        + ("_verify_form" if verify_form else "")
    fn = _bind(_build.load(NAME), entry)
    out = torch.empty_like(q)
    b, g_len, hq, d = q.shape
    num_pages, page, hkv, _ = k_pages.shape
    pools = [k_pages.data_ptr(), v_pages.data_ptr()]
    if int8:
        pools += [k_scale_pages.data_ptr(), v_scale_pages.data_ptr()]
    err = fn(q.data_ptr(), *pools, page_table.data_ptr(), k_new.data_ptr(),
             v_new.data_ptr(), cache_len.data_ptr(), out.data_ptr(), b,
             g_len, hq, hkv, d, num_pages, page, page_table.shape[1],
             _build.stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention: kernel launch failed "
                           f"(cudaError {err})")
    return out, int8


def ragged_paged_decode_attention(q, k_pages, v_pages, page_table, k_new,
                                  v_new, cache_len, k_scale_pages=None,
                                  v_scale_pages=None) -> torch.Tensor:
    """q (B,1,Hq,D); k_pages/v_pages (N,page,Hkv,D) bf16, or int8 with
    ``k_scale_pages``/``v_scale_pages`` (N,page,Hkv) float32; page_table
    (B,P) int32 with ``N`` the unallocated sentinel; k_new/v_new
    (B,Hkv,D) bf16; cache_len (B,) int32 valid tokens excluding the
    current one. Returns (B,1,Hq,D)."""
    if q.device.type == "cpu":
        return ragged_paged_decode_attention_plain(
            q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
            k_scale_pages, v_scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_decode_attention: unsupported "
                         f"device {q.device}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"ragged_paged_decode_attention: q (B,1,Hq,D) "
                         f"expected, got {tuple(q.shape)}")
    global launches, int8_launches
    out, int8 = _launch(q, k_pages, v_pages, page_table, k_new[:, None],
                        v_new[:, None], cache_len, k_scale_pages,
                        v_scale_pages)
    if int8:
        int8_launches += 1
    else:
        launches += 1
    return out


def ragged_paged_verify_attention(q, k_pages, v_pages, page_table, k_new,
                                  v_new, cache_len, k_scale_pages=None,
                                  v_scale_pages=None) -> torch.Tensor:
    """Speculative verify: q (B,G,Hq,D), query ``g`` at position
    ``cache_len + g``; k_new/v_new (B,G,Hkv,D) the G new tokens' K/V,
    attended causally (key ``u <= g``); pools, scale planes, table and
    cache_len as in :func:`ragged_paged_decode_attention`. Returns
    (B,G,Hq,D)."""
    if q.device.type == "cpu":
        return ragged_paged_verify_attention_plain(
            q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
            k_scale_pages, v_scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_verify_attention: unsupported "
                         f"device {q.device}")
    global verify_launches, int8_verify_launches
    out, int8 = _launch(q, k_pages, v_pages, page_table, k_new, v_new,
                        cache_len, k_scale_pages, v_scale_pages)
    if int8:
        int8_verify_launches += 1
    else:
        verify_launches += 1
    return out


def ragged_paged_verify_form_attention(q, k_pages, v_pages, page_table,
                                       k_new, v_new, cache_len,
                                       k_scale_pages=None,
                                       v_scale_pages=None) -> torch.Tensor:
    """The verify launch through the kernel's verify instantiation at any
    G, G = 1 included (the served wrappers take the decode instantiation
    at G = 1), bf16 or int8 pools. Uncounted and on no served path: it
    lets a check hold the two instantiations bit for bit against each
    other at G = 1. CUDA tensors only; arguments as in
    :func:`ragged_paged_verify_attention`."""
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_verify_form_attention: CUDA tensors "
                         f"expected, got {q.device}")
    return _launch(q, k_pages, v_pages, page_table, k_new, v_new, cache_len,
                   k_scale_pages, v_scale_pages, verify_form=True)[0]


def cluster_size(group: int, g_len: int, table_width: int = 64,
                 page: int = 32, head_dim: int = 128) -> int:
    """The kernel's blocks a (KV head, slot) for this launch, as the
    compiled kernel computes it (``gofr_ragged_cluster_size``):
    ``CLUSTER``, or :func:`d64_ranks` for the head_dim-64 body."""
    if not torch.cuda.is_available():
        raise RuntimeError("cluster_size: needs a CUDA device")
    fn = _build.load(NAME).gofr_ragged_cluster_size
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(head_dim, group, g_len, table_width, page)


def cluster_occupancy(group: int, verify: bool, int8: bool, g_len: int,
                      table_width: int = 64, page: int = 32,
                      head_dim: int = 128) -> int:
    """How many clusters of one kernel instantiation (head dim
    ``head_dim``; ``group`` query heads per KV head; the verify or the
    decode new-token bound; int8 or bf16 pools) the current CUDA device
    holds at once, for ``g_len`` queries a slot and a page table of
    ``table_width`` columns of ``page`` positions
    (``cudaOccupancyMaxActiveClusters``); a cluster is
    :func:`cluster_size` blocks."""
    if not torch.cuda.is_available():
        raise RuntimeError("cluster_occupancy: needs a CUDA device")
    fn = _build.load(NAME).gofr_ragged_cluster_occupancy
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    clusters = ctypes.c_int(0)
    err = fn(head_dim, group, int(verify), int(int8), table_width, page,
             g_len, ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"cluster_occupancy: cudaError {err}")
    return clusters.value
