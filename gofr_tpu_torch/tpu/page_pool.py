"""Device-resident KV page pool (counterpart of
``gofr_tpu/tpu/page_pool.py``).

One pool backs every KV byte of the paged serving path: prefill inserts
and decode appends address the same ``(L, num_pages + 1, page, Hkv, Dh)``
leaves, so device memory is ``num_pages x page`` tokens whatever
``max_len`` is. Host state is a free list plus a per-page refcount:
``alloc`` hands out pages at refcount 1 and ``release`` drops one
reference; a page returns to the free list at zero (shared ownership,
``retain``, arrives with the prefix cache).

``num_pages`` doubles as the out-of-bounds sentinel id, and every leaf
holds one page row more, at that index: a scratch page. A write routed
to the sentinel (an inactive slot, a position past the table) lands
there, which is JAX's ``mode="drop"`` without a host-side filter, so a
write's shape never depends on the data. ``alloc`` never hands the
scratch row out, ``stats()`` counts ``num_pages`` usable pages and
``pool_bytes`` counts those alone, and the kernels see the first
``num_pages`` rows, where the sentinel is out of range. The leaves are
written in place by their owners and keep their addresses for the
pool's life (captured CUDA graphs hold them): :meth:`PagePool.reset`
clears them in place. With ``cfg.kv_int8`` the k/v leaves are int8 and
two float32 scale planes ``ks``/``vs`` (L, num_pages + 1, page, Hkv),
ones-initialised, sit beside them.

Left for later slices: the HBM budget arbiter and mesh sharding.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device

__all__ = ["PagePool"]


class PagePool:
    """Refcounted device page pool shared by prefill and decode."""

    def __init__(self, cfg, page: int = 32, num_pages: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        if num_pages is None or int(num_pages) < 1:
            raise ValueError("PagePool needs num_pages >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page = int(page)
        self.num_pages = int(num_pages)
        self.page_bytes = self._page_bytes(cfg, self.page)
        self.writes = 0        # page-rows written into the pool
        self.stalls = 0        # failed allocations (free list exhausted)
        self.allocs = 0
        self.leaves: Dict[str, torch.Tensor] = {}
        self._free: List[int] = []
        self._refs = np.zeros((self.num_pages,), np.int32)
        self.reset()

    @property
    def sentinel(self) -> int:
        """Out-of-bounds page id of an unallocated table entry."""
        return self.num_pages

    @staticmethod
    def _page_bytes(cfg, page: int) -> int:
        """Device bytes one page occupies across every leaf."""
        kv = cfg.n_layers * page * cfg.n_kv_heads * cfg.head_dim
        if cfg.kv_int8:
            scales = cfg.n_layers * page * cfg.n_kv_heads * 4
            return 2 * (kv + scales)          # int8 k+v, f32 ks+vs
        return 2 * kv * torch.finfo(cfg.dtype).bits // 8

    def _alloc_leaves(self) -> None:
        """The leaves, (L, num_pages + 1, page, Hkv, D) with the scratch
        row last: k/v zeroed, scale planes at one."""
        cfg = self.cfg
        shape = (cfg.n_layers, self.num_pages + 1, self.page,
                 cfg.n_kv_heads, cfg.head_dim)
        dev = self.device
        if cfg.kv_int8:
            self.leaves = {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.ones(shape[:-1], dtype=torch.float32,
                                 device=dev),
                "vs": torch.ones(shape[:-1], dtype=torch.float32,
                                 device=dev)}
        else:
            self.leaves = {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}

    def reset(self) -> None:
        """Leaves cleared in place (k/v zeroed, scale planes at one; the
        same tensors at the same addresses) and empty ownership."""
        if not self.leaves:
            self._alloc_leaves()
        else:
            for name, leaf in self.leaves.items():
                leaf.fill_(1 if name in ("ks", "vs") else 0)
        self._free = list(range(self.num_pages))
        self._refs = np.zeros((self.num_pages,), np.int32)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """``n`` pages at refcount 1, all or nothing; None (and a stall
        counted) when the free list is short. Never blocks."""
        if len(self._free) < n:
            self.stalls += 1
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._refs[ids] = 1
        self.allocs += n
        return ids

    def release(self, page_ids: Sequence[int]) -> None:
        """Drop one ref per page; refcount 0 returns the page to the free
        list. Releasing an already-free page is a no-op."""
        for pid in page_ids:
            if self._refs[pid] > 0:
                self._refs[pid] -= 1
                if self._refs[pid] == 0:
                    self._free.append(pid)

    def note_writes(self, pages: int) -> None:
        self.writes += max(0, int(pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def pool_bytes(self) -> int:
        """Bytes of the usable pages; the scratch row adds one page."""
        return self.num_pages * self.page_bytes

    def stats(self) -> Dict[str, Any]:
        return {
            "page_tokens": self.page,
            "num_pages": self.num_pages,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "page_bytes": self.page_bytes,
            "pool_bytes": self.pool_bytes,
            "allocs": self.allocs,
            "writes": self.writes,
            "stalls": self.stalls,
        }
