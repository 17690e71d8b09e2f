"""Background tasks whose deaths are observed (a copy of
``gofr_tpu/aio.py``'s ``spawn_logged``).

``asyncio.ensure_future`` detaches a coroutine: an exception that escapes
it is reported only when the task is garbage-collected. The telemetry
sampler and the trace replay spawn through :func:`spawn_logged`, which
logs such an exception and counts it in
``app_async_task_failures_total{task}``.
"""

from __future__ import annotations

import asyncio

__all__ = ["spawn_logged"]


def spawn_logged(coro, logger=None, name: str = "task",
                 metrics=None) -> asyncio.Task:
    """Schedule ``coro`` as a task whose failure is observed: an escaped
    exception other than cancellation is logged under ``name`` and
    counted. Returns the task, so the caller can still cancel it."""
    task = asyncio.ensure_future(coro)
    task.set_name(name)

    def _observe(done: asyncio.Task) -> None:
        if done.cancelled():
            return
        exc = done.exception()
        if exc is None:
            return
        if logger is not None:
            logger.error("background task %s died: %r", name, exc)
        if metrics is not None:
            metrics.increment_counter("app_async_task_failures_total",
                                      task=name)

    task.add_done_callback(_observe)
    return task
