"""Device-memory pressure for the watchdog and the telemetry store (the
``hbm_occupancy`` half of ``gofr_tpu/hbmz.py``; the ``/debug/hbmz`` page
waits for the app wiring).

:func:`hbm_occupancy` is the fraction the watchdog's ``hbm_fn`` and the
``hbm_occupancy`` signal read: on the card, the bytes the caching
allocator has handed out over the card's total memory; without a card,
the KV page pool's occupancy; else None (unavailable, which must not read
as pressure). Both come from host bookkeeping: neither the allocator's
statistics nor the device properties wait for the card.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["hbm_occupancy"]


def hbm_occupancy(container: Any) -> Optional[float]:
    """HBM-pressure fraction in [0, 1] (JAX ``hbm_occupancy``): the
    engine's card's allocated bytes over its total memory when the
    container's engine (``container.tpu``) serves on a card, else the
    engine's (or a registry's shared) page pool's used pages over its
    pages, else None."""
    tpu = getattr(container, "tpu", None)
    device = getattr(tpu, "device", None)
    if isinstance(device, torch.device) and device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        in_use = torch.cuda.memory_stats(index).get(
            "allocated_bytes.all.current", 0)
        limit = torch.cuda.get_device_properties(index).total_memory
        if limit > 0:
            return min(1.0, in_use / limit)
    pool = getattr(tpu, "_pool", None)
    if pool is None:
        # registry: the shared pool, when one exists
        pool = getattr(tpu, "page_pool", None)
    if pool is not None and getattr(pool, "num_pages", 0):
        return pool.used_pages / pool.num_pages
    return None
