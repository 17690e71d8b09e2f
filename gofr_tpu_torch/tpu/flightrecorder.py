"""Request flight recorder (a copy of ``gofr_tpu/tpu/flightrecorder.py``):
one compact :class:`RequestRecord` per request, in flight and in a
bounded ring of completed ones, and a ring of device steps with their
phase split.

The engine opens a record at submit, marks admission, the batches it
rode, its first token and its terminal status; ``statusz()`` renders
the rings. Plain host bookkeeping — no device syncs, O(1) per event,
bounded memory — so it is always on. The JAX recorder's workload and
worst-offender attachments come with the workload plane.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class RequestRecord:
    """Timeline of one request through the serving stack. Timestamps are
    ``time.monotonic`` (durations); ``wall_enqueued_at`` is ``time.time``
    for display. Batch participation is kept as bounded aggregates (count /
    min / max / sum), not a per-tick list — a long generation must not grow
    the record."""

    __slots__ = ("trace_id", "span_id", "model", "prompt_len", "budget",
                 "wall_enqueued_at", "enqueued_at", "admitted_at",
                 "first_token_at", "finished_at", "tokens", "status",
                 "ticks", "batch_min", "batch_max", "batch_sum",
                 "cached_prefix_len", "pages_held", "kv_transfer_s",
                 "kv_transfer_bytes")

    def __init__(self, model: str = "generate", prompt_len: int = 0,
                 budget: int = 0, trace_id: Optional[str] = None,
                 span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.model = model
        self.prompt_len = prompt_len
        self.budget = budget
        self.wall_enqueued_at = time.time()
        self.enqueued_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.tokens = 0
        self.status = "queued"   # queued|running|done|cancelled|error
        self.ticks = 0
        self.batch_min = 0
        self.batch_max = 0
        self.batch_sum = 0
        self.cached_prefix_len = 0   # prompt tokens served from prefix KV
        self.pages_held = 0          # KV pool pages mapped (paged engine)
        # disaggregated handoff : wire cost of a migrated
        # request's KV transfer — zero for locally prefilled requests
        self.kv_transfer_s = 0.0
        self.kv_transfer_bytes = 0

    # -- event hooks (engine/batcher call these) ---------------------------
    def admitted(self) -> None:
        self.admitted_at = time.monotonic()
        self.status = "running"

    def rode_batch(self, size: int) -> None:
        self.ticks += 1
        self.batch_sum += size
        self.batch_min = size if self.ticks == 1 else min(self.batch_min, size)
        self.batch_max = max(self.batch_max, size)

    def first_token(self) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()

    def finish(self, status: str = "done") -> None:
        if self.finished_at is None:
            self.finished_at = time.monotonic()
            self.status = status

    # -- derived metrics ----------------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.enqueued_at

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.enqueued_at

    @property
    def tokens_per_s(self) -> Optional[float]:
        if self.admitted_at is None or self.tokens == 0:
            return None
        end = self.finished_at or time.monotonic()
        elapsed = end - self.admitted_at
        return self.tokens / elapsed if elapsed > 0 else None

    def to_dict(self) -> Dict[str, Any]:
        def _round(value: Optional[float]) -> Optional[float]:
            return None if value is None else round(value, 6)
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "model": self.model,
            "status": self.status,
            "prompt_len": self.prompt_len,
            "cached_prefix_len": self.cached_prefix_len,
            "pages_held": self.pages_held,
            "budget": self.budget,
            "enqueued_at": self.wall_enqueued_at,
            "queue_wait_s": _round(self.queue_wait_s),
            "ttft_s": _round(self.ttft_s),
            "kv_transfer_s": (_round(self.kv_transfer_s)
                              if self.kv_transfer_bytes else None),
            "kv_transfer_bytes": self.kv_transfer_bytes or None,
            "tokens": self.tokens,
            "tokens_per_s": _round(self.tokens_per_s),
            "batch_sizes": {
                "ticks": self.ticks,
                "min": self.batch_min,
                "max": self.batch_max,
                "mean": (round(self.batch_sum / self.ticks, 2)
                         if self.ticks else None),
            },
        }


class FlightRecorder:
    """Bounded ring buffer of completed :class:`RequestRecord` plus the
    live in-flight set. Lock-guarded: events come from the serving loop,
    snapshots from the admin endpoint, and batcher fetches from worker
    threads."""

    def __init__(self, capacity: int = 256, step_capacity: int = 128):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._inflight: Dict[int, RequestRecord] = {}
        self._completed: "deque[RequestRecord]" = deque(maxlen=capacity)
        # step-phase anatomy ring : one entry per device step
        # with its host_prep/enqueue/device_wait split — the per-step twin
        # of the per-request timeline above
        self._steps: "deque[Dict[str, Any]]" = deque(maxlen=step_capacity)
        self._total = 0
        self._total_steps = 0

    def start(self, record: RequestRecord) -> RequestRecord:
        with self._lock:
            self._total += 1
            self._inflight[id(record)] = record
        return record

    def finish(self, record: RequestRecord, status: str = "done") -> None:
        record.finish(status)
        with self._lock:
            if self._inflight.pop(id(record), None) is not None:
                self._completed.append(record)

    def record_step(self, model: str, bucket: int, batch: int,
                    phases: Dict[str, float]) -> None:
        """One executed device step with its phase split (seconds). Called
        by the executor's fetch — possibly on a worker thread."""
        entry = {
            "at": time.time(),
            "model": model,
            "bucket": bucket,
            "batch": batch,
            "fill": round(batch / bucket, 4) if bucket else None,
            "phases": {name: round(seconds, 6)
                       for name, seconds in phases.items()},
        }
        with self._lock:
            self._total_steps += 1
            self._steps.append(entry)

    def find(self, trace_id: str) -> List[Dict[str, Any]]:
        """All records (in-flight + completed) tagged with ``trace_id``,
        oldest first. Each dict is :meth:`RequestRecord.to_dict` plus a
        ``timing`` block of raw monotonic timestamps so a cross-replica
        stitcher can do gap math on same-clock records ."""
        with self._lock:
            records = [r for r in self._inflight.values()
                       if r.trace_id == trace_id]
            records += [r for r in self._completed if r.trace_id == trace_id]
        records.sort(key=lambda r: r.enqueued_at)
        out = []
        for r in records:
            d = r.to_dict()
            end = r.finished_at if r.finished_at is not None else time.monotonic()
            d["timing"] = {
                "enqueued_at": r.enqueued_at,
                "admitted_at": r.admitted_at,
                "first_token_at": r.first_token_at,
                "finished_at": r.finished_at,
                "duration_s": round(end - r.enqueued_at, 6),
            }
            out.append(d)
        return out

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        with self._lock:
            inflight = [r.to_dict() for r in self._inflight.values()]
            recent = [r.to_dict() for r in self._completed]
            steps = list(self._steps)
            total_steps = self._total_steps
        if limit is not None:
            recent = recent[-limit:]
            steps = steps[-limit:]
        recent.reverse()   # newest first — the ops-facing order
        steps.reverse()
        return {"total_requests": self._total,
                "in_flight": inflight,
                "recent": recent,
                "total_steps": total_steps,
                "steps": steps}
