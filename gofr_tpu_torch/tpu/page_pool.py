"""Device-resident KV page pool (counterpart of
``gofr_tpu/tpu/page_pool.py``).

One pool backs every KV byte of the paged serving path: prefill inserts
and decode appends address the same ``(L, num_pages + 1, page, Hkv, Dh)``
leaves, so device memory is ``num_pages x page`` tokens whatever
``max_len`` is. Host state is a free list plus a per-page refcount:
``alloc`` hands out pages at refcount 1 (calling ``reclaim``, the prefix
store's eviction, while the free list is short), ``retain`` adds a
reference (the prefix trie adopting a slot's page) and ``release`` drops
one; a page returns to the free list at zero.

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
clears them in place, and reallocates them only when ``num_pages`` was
changed since (tests shrink a prefix store's pool). With
``cfg.kv_int8`` the k/v leaves are int8 and two float32 scale planes
``ks``/``vs`` (L, num_pages + 1, page, Hkv), ones-initialised, sit
beside them.

Several engines of one KV geometry may share one pool (multi-model
tenancy, JAX's ``page_pool=``): ``lock``, a re-entrant lock, serialises
``alloc`` / ``retain`` / ``release`` / ``reset`` across their loop
threads, and ``reset`` notifies every subscriber (:meth:`PagePool.
subscribe`), so a co-resident engine drops its page ids. ``epoch`` counts
resets: an owner stamps its page ids with the epoch it took them in and
never releases ids of an earlier one into the fresh pool. The engines
sharing a pool queue their device work from the pool's one device thread
(:attr:`PagePool.executor`), onto the device's default stream, so a page
one engine releases and another allocates is written only after every
read or write of it queued before the release.

:class:`HBMBudget` is JAX's byte-granular arbiter for co-residents of
different geometries (each takes its own pool's ``budget_bytes`` from a
carve).

Over a mesh (``mesh=``, ``parallel/mesh``) each leaf is a
``parallel/sharding.Sharded`` laid out by ``llama_prefix_pool_specs``:
kv heads on ``tp``, pages replicated over every other axis (any slot may
gather any page). Each coordinate's shard is made on its device at its
shape, (L, num_pages + 1, page, Hkv / tp, D), and the host state (free
list, refcounts, the engines' page tables) is one for all of them.
:meth:`PagePool.ranks` is the tp ranks' leaves of the first replica,
what a serving step reads and writes; :meth:`PagePool.replicas` every
replica's. ``page_bytes`` and ``pool_bytes`` count every tp shard of a
page (one replica), as JAX's count the global array.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from gofr_tpu_torch.device import resolve_device

__all__ = ["PagePool", "HBMBudget"]


class PagePool:
    """Refcounted device page pool shared by prefill and decode.
    ``num_pages`` may be given, or derived from ``budget_bytes`` (device
    bytes across every leaf, the scratch row aside)."""

    def __init__(self, cfg, page: int = 32, num_pages: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 budget_bytes: Optional[int] = None, mesh=None,
                 metrics=None):
        if mesh is not None:
            from gofr_tpu_torch.parallel.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise ValueError(
                    f"PagePool: mesh must be a gofr_tpu_torch.parallel.mesh"
                    f".Mesh (make_mesh), got {type(mesh).__name__}")
        # alloc/retain/release/reset take it (re-entrant): engines sharing
        # the pool touch it from their own loop threads
        self.lock = threading.RLock()
        self.mesh = mesh
        self.cfg = cfg
        # duck-typed, as the JAX pool's: page gauges at each alloc and
        # release, stalls, page-rows written
        self.metrics = metrics
        self.device = resolve_device(device)
        self.page = int(page)
        self.page_bytes = self._page_bytes(cfg, self.page)
        if num_pages is None and budget_bytes is not None:
            num_pages = max(1, int(budget_bytes) // self.page_bytes)
        if num_pages is None or int(num_pages) < 1:
            raise ValueError("PagePool needs num_pages >= 1 or budget_bytes")
        self.num_pages = int(num_pages)
        self.writes = 0        # page-rows written into the pool
        self.stalls = 0        # failed allocations (free list exhausted)
        self.allocs = 0
        self.leaves: Dict[str, torch.Tensor] = {}
        self._free: List[int] = []
        self._refs = np.zeros((self.num_pages,), np.int32)
        self._reset_subscribers: List[Callable[[], None]] = []
        self.epoch = -1                # resets so far (0 after __init__)
        self._executor: Optional[ThreadPoolExecutor] = None
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
        row last: k/v zeroed, scale planes at one; over a mesh each
        coordinate's shard on its device."""
        if self.mesh is None:
            self.leaves = self._make_leaves(self.cfg, self.device)
            return
        from gofr_tpu_torch.models.llama import rank_config
        from gofr_tpu_torch.parallel.sharding import (
            assemble, llama_prefix_pool_specs, prune_specs)
        mesh = self.mesh
        tp = mesh.shape.get("tp", 1)
        rank_cfg = rank_config(self.cfg, tp)
        specs = prune_specs(
            llama_prefix_pool_specs(kv_int8=self.cfg.kv_int8), mesh)
        self.leaves = assemble(mesh, specs, lambda coord: self._make_leaves(
            rank_cfg, mesh.devices[coord]))

    def _make_leaves(self, cfg, dev) -> Dict[str, torch.Tensor]:
        shape = (cfg.n_layers, self.num_pages + 1, self.page,
                 cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_int8:
            return {
                "k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "ks": torch.ones(shape[:-1], dtype=torch.float32,
                                 device=dev),
                "vs": torch.ones(shape[:-1], dtype=torch.float32,
                                 device=dev)}
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}

    def replicas(self) -> List[List[Dict[str, torch.Tensor]]]:
        """Every replica of the pool (one for each coordinate of the
        mesh's axes other than tp), each the tp ranks' leaves by name;
        ``[[leaves]]`` without a mesh."""
        if self.mesh is None:
            return [[self.leaves]]
        from gofr_tpu_torch.parallel.sharding import local_tree
        return [[local_tree(self.leaves, coord) for coord in line]
                for line in self.mesh.axis_coords("tp")]

    def ranks(self) -> List[Dict[str, torch.Tensor]]:
        """The tp ranks' leaves of the first replica: what a serving step
        reads and writes (one rank's, the leaves, without a mesh)."""
        return self.replicas()[0]

    def reset(self) -> None:
        """Leaves cleared in place (k/v zeroed, scale planes at one; the
        same tensors at the same addresses, so captured graphs stay
        valid), empty ownership and a new ``epoch``; new leaves when
        ``num_pages`` changed since they were made. Then every subscriber
        is called, outside the lock (JAX's reset fan-out)."""
        with self.lock:
            if not self.leaves \
                    or self.leaves["k"].shape[1] != self.num_pages + 1:
                self._alloc_leaves()
            else:
                for replica in self.replicas():
                    for leaves in replica:
                        for name, leaf in leaves.items():
                            leaf.fill_(1 if name in ("ks", "vs") else 0)
            self._free = list(range(self.num_pages))
            self._refs = np.zeros((self.num_pages,), np.int32)
            self.epoch += 1
            self._set_gauges()
            callbacks = list(self._reset_subscribers)
        for callback in callbacks:
            callback()

    def subscribe(self, callback: Callable[[], None]) -> None:
        """Register a reset observer: a co-resident engine learns that
        another owner reset the pool (its page ids now dangle)."""
        if callback not in self._reset_subscribers:
            self._reset_subscribers.append(callback)

    @property
    def executor(self) -> ThreadPoolExecutor:
        """The one device thread of every engine sharing this pool, made
        at first use: their device work is queued in the order it was
        submitted, so a page released by one engine (after it submitted
        the work that touches the page) and allocated by another (whose
        writes are submitted after the allocation) is written in stream
        order after the first engine's reads and writes of it."""
        with self.lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="gofr-torch-pool")
            return self._executor

    def alloc(self, n: int = 1,
              reclaim: Optional[Callable[[], bool]] = None,
              epoch: Optional[int] = None) -> Optional[List[int]]:
        """``n`` pages at refcount 1, all or nothing. While the free list
        is short, ``reclaim()`` (if given) is called to release evictable
        pages; it returns False when it freed nothing. None (and a stall
        counted) when the list stays short. Never blocks. None too, with
        no stall counted, when ``epoch`` is given and a reset has ended
        it: the caller's page ids are an earlier epoch's, and pages it
        took now would be forgotten when it learns of the reset."""
        with self.lock:
            if epoch is not None and epoch != self.epoch:
                return None
            while len(self._free) < n and reclaim is not None \
                    and reclaim():
                pass
            if len(self._free) < n:
                self.stalls += 1
                if self.metrics is not None:
                    self.metrics.increment_counter(
                        "app_tpu_kv_pages_stalled_total")
                return None
            ids = [self._free.pop() for _ in range(n)]
            self._refs[ids] = 1
            self.allocs += n
            self._set_gauges()
            return ids

    def retain(self, page_ids: Sequence[int]) -> None:
        """One more reference on each page (a second owner)."""
        with self.lock:
            for pid in page_ids:
                self._refs[pid] += 1

    def release(self, page_ids: Sequence[int],
                epoch: Optional[int] = None) -> None:
        """Drop one ref per page; refcount 0 returns the page to the free
        list. Releasing an already-free page is a no-op, and so is
        releasing ids taken in an ``epoch`` before the current one (a
        reset returned them already)."""
        with self.lock:
            if epoch is not None and epoch != self.epoch:
                return
            for pid in page_ids:
                if self._refs[pid] > 0:
                    self._refs[pid] -= 1
                    if self._refs[pid] == 0:
                        self._free.append(pid)
            self._set_gauges()

    def note_writes(self, pages: int) -> None:
        if pages <= 0:
            return
        self.writes += int(pages)
        if self.metrics is not None:
            self.metrics.delta_updown_counter(
                "app_tpu_kv_pages_written_total", float(pages))

    def _set_gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_kv_pages_used",
                                   float(self.used_pages))
            self.metrics.set_gauge("app_tpu_kv_pages_capacity",
                                   float(self.num_pages))

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
            "occupancy": round(self.used_pages / self.num_pages, 6),
            "allocs": self.allocs,
            "writes": self.writes,
            "stalls": self.stalls,
        }


class HBMBudget:
    """Byte-granular device-memory arbiter for multi-model tenancy (JAX
    ``HBMBudget``). Engines of one KV geometry share one :class:`PagePool`;
    co-residents of different geometries cannot share pages, so each
    takes a carve of the card's KV budget in bytes as its own pool's
    ``budget_bytes``. Bookkeeping only (it never touches the card): a
    carve past the budget fails at load, not mid-traffic."""

    def __init__(self, total_bytes: int):
        if total_bytes <= 0:
            raise ValueError("HBMBudget needs a positive byte budget")
        self.total_bytes = int(total_bytes)
        self._carves: Dict[str, int] = {}

    @property
    def carved_bytes(self) -> int:
        return sum(self._carves.values())

    @property
    def free_bytes(self) -> int:
        return self.total_bytes - self.carved_bytes

    def carve(self, name: str, nbytes: int) -> int:
        """Reserve ``nbytes`` for ``name``; raises when the remaining
        budget cannot cover it."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            raise ValueError(f"carve({name!r}) needs a positive size")
        if name in self._carves:
            raise ValueError(f"model {name!r} already holds a carve")
        if nbytes > self.free_bytes:
            raise ValueError(
                f"HBM budget exhausted: {name!r} wants {nbytes} bytes, "
                f"{self.free_bytes} of {self.total_bytes} remain")
        self._carves[name] = nbytes
        return nbytes

    def release(self, name: str) -> None:
        self._carves.pop(name, None)

    def stats(self) -> Dict[str, Any]:
        return {
            "total_bytes": self.total_bytes,
            "carved_bytes": self.carved_bytes,
            "free_bytes": self.free_bytes,
            "carves": dict(self._carves),
        }
