"""Pinned host staging slabs for the engine's per-tick transfers
(counterpart of ``gofr_tpu/tpu/staging.py``'s ``StagingPool``).

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
waits; fetch slabs grow with the fetches outstanding.

On the CPU there is nothing to stage: uploads copy straight into the
destination and a fetch copies the tensor out when it is started.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["StagingPool"]


class _Slab:
    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.event = None       # recorded behind the slab's last copy


class StagingPool:
    """Rings of pinned slabs keyed by (direction, shape, dtype)."""

    def __init__(self, device: torch.device, depth: int = 3):
        self.device = device
        self.depth = max(1, int(depth))
        self._free: Dict[Tuple, deque] = {}
        self._count: Dict[Tuple, int] = {}
        self._lock = threading.Lock()
        self._slab_bytes = 0
        self._uploads = 0
        self._upload_bytes = 0

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
        queued, else after waiting on its event."""
        with self._lock:
            ring = self._free.setdefault(key, deque())
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

    def upload(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """Copy ``src`` into device tensor ``dst`` (same shape) in stream
        order, through a pinned slab."""
        with self._lock:
            self._uploads += 1
            self._upload_bytes += src.nbytes
        if self.device.type != "cuda":
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
            return
        key = ("up", tuple(dst.shape), dst.dtype)
        slab = self._acquire(key)
        slab.host.numpy()[...] = src
        dst.copy_(slab.host, non_blocking=True)
        slab.event = torch.cuda.Event()
        slab.event.record()
        self._release(key, slab)

    def fetch(self, src: torch.Tensor) -> Callable[[], np.ndarray]:
        """Queue the copy of device tensor ``src`` into a pinned slab now,
        in stream order (a later write of ``src`` cannot reach it), and
        return the function that waits for it and returns the values:
        call that one off the dispatching thread."""
        if self.device.type != "cuda":
            values = src.numpy().copy()
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
            values = slab.host.numpy().copy()
            self._release(key, slab)
            return values
        return wait

    def stats(self) -> Dict[str, int]:
        """Uploads made and their bytes, and the pinned slabs' bytes."""
        with self._lock:
            return {"uploads": self._uploads,
                    "upload_bytes": self._upload_bytes,
                    "slab_bytes": self._slab_bytes}
