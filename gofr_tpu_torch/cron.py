"""Cron scheduler (a copy of ``gofr_tpu/cron.py``): 5-field crontab specs
with steps, ranges and lists (``parse_schedule``), ``CronJob``, and the
``Crontab`` task that fires due jobs once a wall-clock minute, each in a
span with a no-op request Context, timed in ``app_cron_duration`` and
counted in ``app_cron_runs_total``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Dict, List, Optional, Set

from gofr_tpu_torch.aio import spawn_logged
from gofr_tpu_torch.context import Context

_FIELDS = (
    ("minute", 0, 59),
    ("hour", 0, 23),
    ("day", 1, 31),
    ("month", 1, 12),
    ("dow", 0, 6),
)


class CronParseError(ValueError):
    pass


def parse_schedule(spec: str) -> Dict[str, Set[int]]:
    """Parse a 5-field cron spec into per-field allowed value sets
    (cron.go:86-216)."""
    parts = spec.split()
    if len(parts) != 5:
        raise CronParseError(f"schedule {spec!r} must have 5 fields")
    out: Dict[str, Set[int]] = {}
    for (name, low, high), token in zip(_FIELDS, parts):
        out[name] = _parse_field(token, low, high, spec)
    return out


def _parse_field(token: str, low: int, high: int, spec: str) -> Set[int]:
    values: Set[int] = set()
    for piece in token.split(","):
        piece = piece.strip()
        step = 1
        if "/" in piece:
            piece, _, step_text = piece.partition("/")
            try:
                step = int(step_text)
            except ValueError as exc:
                raise CronParseError(f"bad step in {spec!r}") from exc
            if step <= 0:
                raise CronParseError(f"bad step in {spec!r}")
        if piece in ("*", ""):
            start, end = low, high
        elif "-" in piece:
            a, _, b = piece.partition("-")
            try:
                start, end = int(a), int(b)
            except ValueError as exc:
                raise CronParseError(f"bad range in {spec!r}") from exc
        else:
            try:
                start = end = int(piece)
            except ValueError as exc:
                raise CronParseError(f"bad value in {spec!r}") from exc
        if start < low or end > high or start > end:
            raise CronParseError(
                f"value out of range [{low},{high}] in {spec!r}")
        values.update(range(start, end + 1, step))
    return values


class _NoopRequest:
    """The empty request a cron-fired Context carries (cron.go:326-347)."""

    def param(self, key: str) -> str:
        return ""

    def path_param(self, key: str) -> str:
        return ""

    def bind(self, target=None):
        return None

    def header(self, key: str) -> str:
        return ""


class CronJob:
    def __init__(self, spec: str, name: str, func: Callable):
        self.schedule = parse_schedule(spec)
        self.spec = spec
        self.name = name or getattr(func, "__name__", "cron-job")
        self.func = func

    def due(self, when: time.struct_time) -> bool:
        # struct_time: tm_wday Monday=0; cron: Sunday=0
        sched = self.schedule
        return (when.tm_min in sched["minute"]
                and when.tm_hour in sched["hour"]
                and when.tm_mday in sched["day"]
                and when.tm_mon in sched["month"]
                and ((when.tm_wday + 1) % 7) in sched["dow"])


class Crontab:
    def __init__(self, container):
        self.container = container
        self.jobs: List[CronJob] = []
        self._task: Optional[asyncio.Task] = None

    def add_job(self, spec: str, name: str, func: Callable) -> None:
        self.jobs.append(CronJob(spec, name, func))

    def start(self) -> None:
        if self.jobs and self._task is None:
            self._task = spawn_logged(
                self._tick_loop(), self.container.logger, "cron.tick_loop",
                metrics=self.container.metrics)

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _tick_loop(self) -> None:
        """Fire due jobs once per wall-clock minute (cron.go:61-75)."""
        last_minute = -1
        while True:
            now = time.localtime()
            if now.tm_min != last_minute:
                last_minute = now.tm_min
                for job in self.jobs:
                    if job.due(now):
                        # _run_job already isolates handler panics; the
                        # spawn_logged callback catches bugs in the
                        # isolation itself (span/metrics plumbing)
                        spawn_logged(self._run_job(job),
                                     self.container.logger,
                                     f"cron.{job.name}",
                                     metrics=self.container.metrics)
            await asyncio.sleep(60 - time.localtime().tm_sec + 0.05)

    async def _run_job(self, job: CronJob) -> None:
        """Run one firing inside a span with a no-op request Context
        (cron.go:244-254), with panic isolation. Each firing is observed:
        ``app_cron_duration`` (per job) plus an ``app_cron_runs_total``
        success/failure count, so a silently-failing nightly job shows up
        in dashboards and not just in a log line."""
        ctx = Context(_NoopRequest(), self.container)
        metrics = self.container.metrics
        started = time.perf_counter()
        with self.container.tracer.start_span(f"cron:{job.name}"):
            try:
                result = job.func(ctx)
                if hasattr(result, "__await__"):
                    await result
                metrics.increment_counter("app_cron_runs_total",
                                          job=job.name, result="success")
            except Exception as exc:
                self.container.logger.error(
                    "cron job %s panicked: %r", job.name, exc)
                metrics.increment_counter("app_cron_runs_total",
                                          job=job.name, result="failure")
            finally:
                metrics.record_histogram(
                    "app_cron_duration", time.perf_counter() - started,
                    job=job.name)
