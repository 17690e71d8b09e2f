"""Dynamic batching: coalesce concurrent single requests into one
executor step (counterpart of ``gofr_tpu/tpu/batcher.py``).

One accumulator per model on the app's asyncio loop (no locks on the hot
path: the loop serializes). The first request arms a ``max_delay`` timer;
the batch flushes on whichever comes first of ``max_batch`` or the
timer. A warm bucket dispatches on the loop (``dispatch_rows``: the rows
written straight into the executor's staging slab, the upload, the
graph's replay and the output copy queued on the executor's stream) and
fetches in a worker thread, so batch N+1 is queued while batch N runs; a
cold bucket (a capture) runs ``predict`` in a worker thread under a copy
of the dispatching context. A request whose deadline passed while it
queued is shed at flush with ``DeadlineExceeded``.

Tracing: each request's span gets a ``queue.wait`` child covering submit
to flush, and every flushed batch runs under one ``tpu.batch`` step span
linked to the requests it serves.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import time
from typing import Any, Dict, List, Optional

import numpy as np

from gofr_tpu_torch.aio import spawn_logged
from gofr_tpu_torch.slo import DeadlineExceeded, current_deadline
from gofr_tpu_torch.tpu.executor import tree_map
from gofr_tpu_torch.trace import Span

__all__ = ["DynamicBatcher"]


class _Pending:
    __slots__ = ("examples", "futures", "spans", "deadlines", "timer")

    def __init__(self):
        self.examples: List[Any] = []
        self.futures: List[asyncio.Future] = []
        self.spans: List[Optional[Span]] = []   # queue.wait span per example
        self.deadlines: List[Optional[float]] = []  # abs monotonic, or None
        self.timer: Optional[asyncio.TimerHandle] = None


class DynamicBatcher:
    def __init__(self, executor, max_batch: int = 32,
                 max_delay_ms: float = 2.0, logger=None, tracer=None,
                 slo=None, metrics=None, workload=None):
        self.executor = executor
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        self.logger = logger
        self.tracer = tracer
        self.slo = slo  # SLOTracker (goodput/outcome accounting), optional
        self.metrics = metrics
        # the traffic recorder's arrival pulse per enqueue; None: no cost
        self.workload = workload
        self._pending: Dict[str, _Pending] = {}
        # "full" flushes: max_batch binds; "timer" flushes: traffic does
        self.flush_causes: Dict[str, int] = {"full": 0, "timer": 0}

    async def predict(self, name: str, example: Any) -> Any:
        """Submit ONE example (no batch axis); returns its result slice."""
        loop = asyncio.get_running_loop()
        pending = self._pending.setdefault(name, _Pending())
        future: asyncio.Future = loop.create_future()
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span("queue.wait")
            span.set_attribute("model", name)
        pending.examples.append(example)
        pending.futures.append(future)
        pending.spans.append(span)
        if self.workload is not None:
            self.workload.note_enqueue(name)
        # the request's deadline rides with the example: checked again at
        # flush time, after the queue wait has eaten part of the budget
        pending.deadlines.append(current_deadline())
        if len(pending.examples) >= self.max_batch:
            self._flush(name, cause="full")
        elif pending.timer is None:
            pending.timer = loop.call_later(self.max_delay,
                                            self._flush, name)
        return await future

    def apply_operating_point(self, max_batch: Optional[int] = None,
                              max_delay_ms: Optional[float] = None
                              ) -> Dict[str, Any]:
        """Retune the coalescing knobs: validate, then swap with no await,
        so an enqueue sees either the old knobs or the new ones; queued
        examples and armed timers are untouched. Returns the values."""
        if max_batch is not None:
            max_batch = int(max_batch)
            if max_batch < 1:
                raise ValueError(
                    f"apply_operating_point: max_batch {max_batch} "
                    f"must be >= 1")
        if max_delay_ms is not None:
            max_delay_ms = float(max_delay_ms)
            if max_delay_ms < 0:
                raise ValueError(
                    f"apply_operating_point: max_delay_ms "
                    f"{max_delay_ms} must be >= 0")
        if max_batch is not None:
            self.max_batch = max_batch
        if max_delay_ms is not None:
            self.max_delay = max_delay_ms / 1000.0
        return {"max_batch": self.max_batch,
                "max_delay_ms": self.max_delay * 1000.0}

    def queue_depths(self) -> Dict[str, int]:
        """Examples waiting for a flush, per model."""
        return {name: len(p.examples)
                for name, p in self._pending.items() if p.examples}

    def _flush(self, name: str, cause: str = "timer") -> None:
        pending = self._pending.get(name)
        if pending is None or not pending.examples:
            return
        if pending.timer is not None:
            pending.timer.cancel()
        self._pending[name] = _Pending()
        self.flush_causes[cause] = self.flush_causes.get(cause, 0) + 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_flush_total",
                                           cause=cause, model=name)
            self.metrics.record_histogram(
                "app_tpu_batch_fill",
                len(pending.examples) / max(self.max_batch, 1), model=name)
        for span in pending.spans:
            if span is not None:
                span.set_attribute("batch_size", len(pending.examples))
                span.finish()
        spawn_logged(self._run(name, pending.examples,
                               pending.futures, pending.deadlines,
                               pending.spans),
                     self.logger, f"tpu.batch.{name}", metrics=self.metrics)

    def _shed_expired(self, name: str, examples, futures, deadlines, spans):
        """Fail the examples whose deadline already passed with
        ``DeadlineExceeded`` (executing them burns a device step on an
        answer nobody waits for); returns the live (example, future,
        deadline, span) entries."""
        now = time.monotonic()
        live = []
        for entry in zip(examples, futures, deadlines, spans):
            deadline = entry[2]
            if deadline is not None and now > deadline:
                if not entry[1].done():
                    entry[1].set_exception(DeadlineExceeded())
                if self.slo is not None:
                    self.slo.record_outcome("expired")
                if self.logger is not None:
                    self.logger.warn("tpu batch %s: shed expired request "
                                     "(%.1fms past deadline)", name,
                                     (now - deadline) * 1000.0)
            else:
                live.append(entry)
        return live

    async def _run(self, name: str, examples, futures, deadlines,
                   spans) -> None:
        loop = asyncio.get_running_loop()
        live = self._shed_expired(name, examples, futures, deadlines, spans)
        if not live:
            return
        examples, futures, deadlines, spans = (list(col)
                                               for col in zip(*live))
        step_span = None
        if self.tracer is not None:
            # the fused step's root span, linked to every request it serves
            step_span = Span(self.tracer, "tpu.batch")
            step_span.set_attribute("model", name)
            step_span.set_attribute("batch_size", len(examples))
            for span in spans:
                if span is not None:
                    step_span.add_link(span)
        try:
            with step_span if step_span is not None \
                    else contextlib.nullcontext():
                if self.executor.is_warm(name, len(examples)):
                    # warm: rows into the slab, upload, replay and output
                    # copy queued here on the loop; the wait off it
                    handle = self.executor.dispatch_rows(name, examples)
                    result = await loop.run_in_executor(
                        None, self.executor.fetch, handle)
                else:
                    # cold (a capture): off the loop, in the step span's
                    # context
                    batch = _stack(examples)
                    ctx = contextvars.copy_context()
                    result = await loop.run_in_executor(
                        None, ctx.run, self.executor.predict, name, batch)
            finished_at = time.monotonic()
            for i, future in enumerate(futures):
                if not future.done():  # the request may have gone
                    future.set_result(tree_map(lambda leaf: leaf[i], result))
                if self.slo is not None:
                    self.slo.record_outcome(
                        self.slo.classify(deadlines[i], finished_at))
        except Exception as exc:
            if self.logger is not None:
                self.logger.error("tpu batch %s failed: %r", name, exc)
            for future in futures:
                if not future.done():
                    future.set_exception(exc)
                # errored traffic must not vanish from goodput
                if self.slo is not None:
                    self.slo.record_outcome("error")


def _stack(examples):
    """Stack per-request examples into one batch (the cold path's copy)."""
    return tree_map(lambda *leaves: np.stack([np.asarray(l) for l in leaves]),
                    *examples)
