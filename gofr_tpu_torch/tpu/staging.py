"""Pinned host staging slabs for the engine's per-tick transfers, and
upload coalescing (counterpart of ``gofr_tpu/tpu/staging.py``'s
``StagingPool`` and ``TransferCoalescer``).

Every host→device upload of a tick (its active mask, the page table when
its version moved, an admission's rows) and every device→host token
fetch goes through a page-locked slab with ``non_blocking=True``, so the
copy is queued on the stream in order with the ticks around it and the
dispatching thread never waits for the card. A pageable
``torch.as_tensor(array, device="cuda")`` would stall the host until the
stream drains.

A slab is reused only once the copy that read it (an upload) or wrote it
(a fetch) is done: an upload slab goes back to its ring with the CUDA
event recorded behind its copy and waits on that event before it is
written again; a fetch slab goes back only after its reader has copied
it out, which it does after the event. Each ring grows to ``depth``
slabs (the engine's ``max_inflight_ticks + 1``) before an upload ever
waits, and shrinks to it when ``depth`` is lowered (an operating point's
``staging_depth``); fetch slabs grow with the fetches outstanding.

On the CPU there is nothing to stage: uploads copy straight into the
destination and a fetch copies the tensor out when it is started.

The executor's half (JAX ``StagingPool.acquire`` / ``retire``): a ring of
row slabs per (model, bucket) key, each a set of pinned host buffers
matching the bucket's input leaves (numpy views of pinned tensors; plain
numpy arrays on the CPU). The executor writes each request's rows
straight into a slab, copies the slab into the bucket's static inputs
and retires it with the event recorded behind that copy. A ring grows
to ``depth`` slabs before an acquire ever waits; then it waits on its
oldest slab's event (``reuse_waits``), by which point the card has read
the slab's bytes.

Metered uploads (JAX's ``app_tpu_h2d_bytes_total`` /
``app_tpu_h2d_seconds`` by ``path``): every upload adds its bytes and the
host seconds its call took (the copy is queued, not waited for, as JAX's
``device_put`` is) to host counters, on whatever thread makes it (the
engine's device thread); :meth:`StagingPool.drain_meter` hands the
entries to the caller, which emits them (the engine does at publish, on
its loop thread, where every hook runs).

:class:`TransferCoalescer` ships a group of small 4-byte arrays (JAX's
eligibility rule: native little-endian ``int``/``uint``/``float`` of
itemsize 4) as one transfer. Its destinations are typed views at
4-byte-aligned offsets of one device byte buffer (:meth:`TransferCoalescer.
arena`), made before any graph captures them and never reallocated: one
pinned blob is filled with every array's bytes at its view's offset and
copied in one ``copy_``, so the values are bit-exact by construction and
no split runs on the card. A group that does not qualify, or does not
cover its arena, goes array by array.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["StagingPool", "TransferCoalescer"]


def _host_values(tensor: torch.Tensor) -> np.ndarray:
    """A host tensor's values as a numpy array of their own (bfloat16
    widened to float32, exactly). On the event loop it runs only in
    :meth:`StagingPool.fetch`'s CPU branch, on a host tensor; on the card
    it reads a pinned slab inside the returned wait, off the loop."""
    if tensor.dtype == torch.bfloat16:
        # graftcheck: ignore[GT001] — a host tensor (see above): .numpy()
        # of the widened copy is a view, never a device->host sync
        return tensor.float().numpy()
    # graftcheck: ignore[GT001,GT007] — a host tensor (see above), and
    # the copy is the output's one host copy: the slab it reads is
    # recycled for the next fetch
    return tensor.numpy().copy()


class _Slab:
    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.event = None       # recorded behind the slab's last copy


class _RowSlab:
    """One set of host buffers matching a bucket's leaves: ``tensors``
    (pinned on the card) and ``buffers``, numpy views of them; ``event``
    is recorded behind the copy that last read them."""

    __slots__ = ("tensors", "buffers", "event")

    def __init__(self, specs: Sequence[Tuple[Tuple[int, ...], str]],
                 pinned: bool):
        self.buffers: List[np.ndarray] = []
        self.tensors: List[torch.Tensor] = []
        for shape, dtype in specs:
            if pinned:
                tensor = torch.empty(
                    tuple(shape), pin_memory=True,
                    dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
                tensor.zero_()
                buf = tensor.numpy()
            else:
                buf = np.zeros(tuple(shape), np.dtype(dtype))
                tensor = torch.from_numpy(buf)
            self.buffers.append(buf)
            self.tensors.append(tensor)
        self.event: Any = None

    def matches(self, specs) -> bool:
        return len(self.buffers) == len(specs) and all(
            buf.shape == tuple(shape) and buf.dtype == np.dtype(dtype)
            for buf, (shape, dtype) in zip(self.buffers, specs))

    @property
    def nbytes(self) -> int:
        return sum(buf.nbytes for buf in self.buffers)


class StagingPool:
    """Rings of pinned slabs keyed by (direction, shape, dtype), and the
    executor's rings of row slabs keyed by (model, bucket)."""

    def __init__(self, device: torch.device, depth: int = 3):
        self.device = device
        self.depth = max(1, int(depth))
        self._free: Dict[Tuple, deque] = {}
        self._count: Dict[Tuple, int] = {}
        self._lock = threading.Lock()
        self._slab_bytes = 0
        self._uploads = 0
        self._upload_bytes = 0
        self._upload_seconds = 0.0
        self._meter: List[Tuple[str, int, float]] = []
        self._rows: Dict[Any, deque] = {}
        self._row_count: Dict[Any, int] = {}
        self._reuse_waits = 0

    # -- the executor's row slabs (JAX acquire / retire) ----------------------
    def acquire(self, key: Any, specs: Sequence[Tuple[Tuple[int, ...], str]]
                ) -> _RowSlab:
        """A row slab of ``key``'s ring whose buffers match ``specs``
        ((shape, numpy dtype name) a leaf), safe to write: a fresh one
        while the ring is under ``depth`` and its free slabs' copies may
        be queued, else the oldest after waiting on its event. A slab of
        another geometry is dropped (the pinned allocator keeps its block
        until the event behind its copy)."""
        while True:
            with self._lock:
                ring = self._rows.setdefault(key, deque())
                slab = ring.popleft() if ring else None
                grow = self._row_count.get(key, 0) < self.depth
            if slab is None:
                return self._new_rows(key, specs)
            if not slab.matches(specs):
                self._forget_rows(key, slab)
                continue
            if slab.event is not None:
                if grow:
                    with self._lock:
                        ring.appendleft(slab)
                    return self._new_rows(key, specs)
                self._reuse_waits += 1
                slab.event.synchronize()
                slab.event = None
            return slab

    def retire(self, key: Any, slab: _RowSlab, event: Any) -> None:
        """Give ``slab`` back to ``key``'s ring with ``event`` (None: no
        copy in flight) recorded behind the copy that read it; a ring past
        ``depth`` drops its oldest."""
        slab.event = event
        with self._lock:
            ring = self._rows.setdefault(key, deque())
            ring.append(slab)
            while len(ring) > self.depth:
                dropped = ring.popleft()
                self._row_count[key] -= 1
                self._slab_bytes -= dropped.nbytes

    def _new_rows(self, key: Any, specs) -> _RowSlab:
        slab = _RowSlab(specs, pinned=self.device.type == "cuda")
        with self._lock:
            self._row_count[key] = self._row_count.get(key, 0) + 1
            self._slab_bytes += slab.nbytes
        return slab

    def _forget_rows(self, key: Any, slab: _RowSlab) -> None:
        with self._lock:
            self._row_count[key] = max(0, self._row_count.get(key, 1) - 1)
            self._slab_bytes -= slab.nbytes

    def _new(self, key: Tuple) -> _Slab:
        _, shape, dtype = key
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        with self._lock:
            self._count[key] = self._count.get(key, 0) + 1
            self._slab_bytes += host.numel() * host.element_size()
        return _Slab(host)

    def _acquire(self, key: Tuple) -> _Slab:
        """The ring's oldest free slab, once safe to write: a fresh slab
        while the ring is under ``depth`` and that one's copy is still
        queued, else after waiting on its event. A ring over ``depth``
        (the depth was lowered) first gives up its newest free slabs
        until it is at ``depth`` or has one free slab left: a slab whose
        copy is still queued is safe to drop, since the pinned allocator
        keeps its block until the event it recorded behind that copy."""
        with self._lock:
            ring = self._free.setdefault(key, deque())
            while len(ring) > 1 and self._count[key] > self.depth:
                host = ring.pop().host
                self._count[key] -= 1
                self._slab_bytes -= host.numel() * host.element_size()
            slab = ring.popleft() if ring else None
            grow = self._count.get(key, 0) < self.depth
        if slab is None:
            return self._new(key)
        if slab.event is not None and not slab.event.query():
            if grow:
                with self._lock:
                    ring.appendleft(slab)
                return self._new(key)
            slab.event.synchronize()
        return slab

    def _release(self, key: Tuple, slab: _Slab) -> None:
        with self._lock:
            self._free.setdefault(key, deque()).append(slab)

    def reserve(self, tensor: torch.Tensor, upload: bool = True) -> None:
        """Make the ring of ``tensor``'s shape and type now: ``depth``
        upload slabs, or one fetch slab (``upload=False``), so a warmed
        shape allocates no pinned memory while serving. Nothing on the
        CPU."""
        if self.device.type != "cuda":
            return
        key = ("up" if upload else "down", tuple(tensor.shape),
               tensor.dtype)
        want = self.depth if upload else 1
        while self._count.get(key, 0) < want:
            self._release(key, self._new(key))

    def upload(self, dst: torch.Tensor, src: np.ndarray,
               path: str = "dispatch") -> None:
        """Copy ``src`` into device tensor ``dst`` (same shape) in stream
        order, through a pinned slab; metered under ``path``."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        else:
            key = ("up", tuple(dst.shape), dst.dtype)
            slab = self._acquire(key)
            slab.host.numpy()[...] = src
            dst.copy_(slab.host, non_blocking=True)
            slab.event = torch.cuda.Event()
            slab.event.record()
            self._release(key, slab)
        self.note_h2d(int(src.nbytes), time.perf_counter() - t0, path)

    def upload_parts(self, parts: Sequence[np.ndarray], path: str
                     ) -> Tuple[torch.Tensor, List[int]]:
        """Copy the bytes of each host array of ``parts`` into one new
        device ``uint8`` buffer, each at an 8-byte-aligned offset, in
        stream order: on the card through a pinned slab of the next
        power-of-two size (a ring a size, so a payload of any size reuses
        a few slabs), filled straight from the arrays. Metered under
        ``path`` as one transfer. Returns the buffer and the offsets."""
        t0 = time.perf_counter()
        spans, at = [], 0
        for part in parts:
            spans.append(at)
            at += -(-part.nbytes // 8) * 8
        if self.device.type != "cuda":
            blob = np.zeros((at,), np.uint8)
            host = blob
        else:
            key = ("up", (1 << max(12, (at - 1).bit_length()),), torch.uint8)
            slab = self._acquire(key)
            host = slab.host.numpy()
        for part, off in zip(parts, spans):
            host[off:off + part.nbytes] = np.ascontiguousarray(
                part).reshape(-1).view(np.uint8)
        if self.device.type != "cuda":
            dst = torch.from_numpy(blob)
        else:
            dst = torch.empty((at,), dtype=torch.uint8, device=self.device)
            dst.copy_(slab.host[:at], non_blocking=True)
            slab.event = torch.cuda.Event()
            slab.event.record()
            self._release(key, slab)
        self.note_h2d(at, time.perf_counter() - t0, path)
        return dst, spans

    def note_h2d(self, nbytes: int, seconds: float, path: str) -> None:
        """Count one host-to-device transfer of ``nbytes`` that took
        ``seconds`` of host time, under ``path`` (JAX ``note_h2d``)."""
        with self._lock:
            self._uploads += 1
            self._upload_bytes += nbytes
            self._upload_seconds += seconds
            self._meter.append((path, nbytes, seconds))

    def drain_meter(self) -> List[Tuple[str, int, float]]:
        """The (path, bytes, seconds) of every transfer since the last
        drain, oldest first."""
        with self._lock:
            out, self._meter = self._meter, []
        return out

    def fetch(self, src: torch.Tensor) -> Callable[[], np.ndarray]:
        """Queue the copy of device tensor ``src`` into a pinned slab now,
        in stream order (a later write of ``src`` cannot reach it), and
        return the function that waits for it and returns the values:
        call that one off the dispatching thread. A bfloat16 tensor's
        values come back widened to float32 (numpy has no bfloat16)."""
        if self.device.type != "cuda":
            values = _host_values(src)
            return lambda: values
        key = ("down", tuple(src.shape), src.dtype)
        with self._lock:
            ring = self._free.setdefault(key, deque())
            slab = ring.popleft() if ring else None
        if slab is None:
            slab = self._new(key)
        slab.host.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()

        def wait() -> np.ndarray:
            event.synchronize()
            values = _host_values(slab.host)
            self._release(key, slab)
            return values
        return wait

    def stats(self) -> Dict[str, Any]:
        """JAX's keys: the ring depth, the row slabs a key, the host slabs'
        bytes, the waits for a row slab's copy, and the uploads made, their
        bytes and their rate over the host seconds their calls took."""
        with self._lock:
            return {"depth": self.depth,
                    "slabs": {str(k): v for k, v in self._row_count.items()
                              if v},
                    "reuse_waits": self._reuse_waits,
                    "uploads": self._uploads,
                    "upload_bytes": self._upload_bytes,
                    "upload_mb_per_s": (
                        round(self._upload_bytes / self._upload_seconds
                              / 2**20, 1)
                        if self._upload_seconds > 0 else None),
                    "slab_bytes": self._slab_bytes}


class TransferCoalescer:
    """One host-to-device transfer for a group of small 4-byte arrays
    whose destinations are views of one arena (see the module
    docstring). Metered under ``path="coalesced"`` through the staging
    pool; ``stats()`` keeps JAX's keys."""

    _ITEM = 4   # only 4-byte dtypes qualify; everything else goes alone

    def __init__(self, staging: StagingPool):
        self.staging = staging
        self._transfers = 0
        self._arrays = 0
        self._bytes = 0

    @classmethod
    def arena(cls, device: torch.device,
              specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One zeroed uint8 device buffer and a typed view of it per
        ``(shape, dtype)``, each at a 4-byte-aligned offset, in order."""
        spans, at = [], 0
        for shape, dtype in specs:
            at = -(-at // cls._ITEM) * cls._ITEM
            nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
            spans.append((at, nbytes))
            at += nbytes
        buf = torch.zeros((-(-at // cls._ITEM) * cls._ITEM,),
                          dtype=torch.uint8, device=device)
        return buf, [buf[off:off + nbytes].view(dtype).view(shape)
                     for (shape, dtype), (off, nbytes) in zip(specs, spans)]

    @classmethod
    def _eligible(cls, arrays: Sequence[np.ndarray]) -> bool:
        return bool(arrays) and all(
            a.dtype.itemsize == cls._ITEM and a.dtype.kind in "iuf"
            and a.dtype.byteorder in "=<|" for a in arrays)

    def upload(self, arena: Optional[torch.Tensor],
               group: Sequence[Tuple[torch.Tensor, np.ndarray]]) -> None:
        """Upload each ``(view, host array)`` of ``group``: with ``arena``
        given (``group`` then holds every view of it) and two or more
        arrays, all eligible, as one transfer of the arena; otherwise
        each on its own (``path="dispatch"``)."""
        hosts = [np.ascontiguousarray(src) for _, src in group]
        if arena is None or len(group) < 2 or not self._eligible(hosts):
            for (view, _), src in zip(group, hosts):
                self.staging.upload(view, src)
            return
        t0 = time.perf_counter()
        blob = np.zeros((arena.numel(),), np.uint8)
        base = arena.storage_offset()
        for (view, _), src in zip(group, hosts):
            off = view.storage_offset() * view.element_size() - base
            blob[off:off + src.nbytes] = src.reshape(-1).view(np.uint8)
        dev = self.staging.device
        if dev.type != "cuda":
            arena.copy_(torch.from_numpy(blob))
        else:
            key = ("up", tuple(arena.shape), arena.dtype)
            slab = self.staging._acquire(key)
            slab.host.numpy()[...] = blob
            arena.copy_(slab.host, non_blocking=True)
            slab.event = torch.cuda.Event()
            slab.event.record()
            self.staging._release(key, slab)
        self._transfers += 1
        self._arrays += len(group)
        self._bytes += int(blob.nbytes)
        self.staging.note_h2d(int(blob.nbytes), time.perf_counter() - t0,
                              "coalesced")

    def stats(self) -> Dict[str, Any]:
        return {
            "transfers": self._transfers,
            "arrays_coalesced": self._arrays,
            "bytes": self._bytes,
            "arrays_per_transfer": (round(self._arrays / self._transfers, 2)
                                    if self._transfers else None),
        }
