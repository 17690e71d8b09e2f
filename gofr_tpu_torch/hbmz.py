"""Device-memory attribution over HTTP, ``/debug/hbmz``, and the
pressure signal the watchdog and the telemetry store read (the port's
copy of ``gofr_tpu/hbmz.py``).

:func:`build_hbmz` renders the engine's (or a registry's)
``hbm_attribution()``: what the serving stack knowingly placed on the
card (parameters, the KV cache or page pool by ownership, a draft's
cache) against the caching allocator's figure, the difference an
explicit ``unattributed`` residual (graph pools, activations, cuBLAS
workspaces, fragmentation); it sets the
``app_tpu_hbm_attributed_bytes`` / ``app_tpu_hbm_unattributed_bytes``
gauges. :func:`enable_hbmz` is the HTTP binding and points the
watchdog's ``hbm_fn`` at :func:`hbm_occupancy`.

:func:`hbm_occupancy` is the fraction the watchdog's ``hbm_fn`` and the
``hbm_occupancy`` signal read: on the card, the bytes the caching
allocator has handed out over the card's total memory; without a card,
the KV page pool's occupancy; else None (unavailable, which must not read
as pressure). Both come from host bookkeeping: neither the allocator's
statistics nor the device properties wait for the card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

__all__ = ["build_hbmz", "hbm_occupancy", "enable_hbmz"]


def build_hbmz(container, metrics=None) -> Dict[str, Any]:
    """One attribution snapshot from whatever the container wired
    (engine or model registry: both duck-type ``hbm_attribution``)."""
    tpu = getattr(container, "tpu", None)
    attribution_fn = getattr(tpu, "hbm_attribution", None)
    if attribution_fn is None:
        return {"error": "no engine with hbm_attribution wired",
                "at": time.time()}
    report = attribution_fn()
    report["at"] = time.time()
    report["occupancy"] = hbm_occupancy(container)
    metrics = metrics if metrics is not None \
        else getattr(container, "metrics", None)
    if metrics is not None:
        if report.get("attributed_bytes") is not None:
            metrics.set_gauge("app_tpu_hbm_attributed_bytes",
                              float(report["attributed_bytes"]))
        if report.get("unattributed_bytes") is not None:
            metrics.set_gauge("app_tpu_hbm_unattributed_bytes",
                              float(report["unattributed_bytes"]))
    return report


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


def enable_hbmz(app, prefix: str = "/debug/hbmz") -> None:
    container = app.container
    watchdog = getattr(container, "watchdog", None)
    if watchdog is not None and hasattr(watchdog, "hbm_fn"):
        watchdog.hbm_fn = lambda: hbm_occupancy(container)

    def hbmz(ctx):
        return build_hbmz(container)

    app.get(prefix, hbmz)
