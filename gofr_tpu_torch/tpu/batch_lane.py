"""BatchLane: pub/sub generation jobs into the WFQ ``batch`` class (a
copy of ``gofr_tpu/tpu/batch_lane.py`` over the port's engine).

Consumers pull JSON generation jobs from a topic and submit them to the
engine with **no deadline**, so the port's own deadline contextvar
(``gofr_tpu_torch.slo``) reads None and the engine's
:func:`~gofr_tpu_torch.tpu.sched.deadline_class` files them under the
weighted-fair ``batch`` class, which soaks idle capacity without
starving interactive traffic. Results go back with the consuming
trace's ``traceparent`` (the result ``pubsub.publish`` span is a child
of the job's ``pubsub.consume`` span through the tracer's contextvar).

Contracts:

- **Job** (JSON): ``{"id": str, "prompt_ids": [int] | "prompt": str,
  "max_new_tokens": int, "eos_id": int|null, "sampling": {temperature,
  top_k, top_p, seed}, "response_format": {...}|null, "model":
  str|null, "result_topic": str|null}``. ``prompt`` (text) needs an
  ``encode`` hook; ``model`` routes through a ModelRegistry when one
  backs the lane.
- **Result**: ``{"id", "model", "tokens", "text"?, "finish_reason":
  "stop"|"length", "usage": {prompt_tokens, completion_tokens,
  total_tokens}}`` published to ``result_topic`` (the job's wins).
- **Dead letter**: any per-job failure (malformed JSON, validation,
  grammar compile, engine error) becomes ``{"id", "error": {"type",
  "message"}, "job": <raw payload, truncated>}`` on the dead-letter
  topic. The job is committed either way: one poison pill never kills
  the subscriber or wedges the partition.

Backpressure: before every pull the lane reads the engine's admission
depth (``admission_depth()``), the paged pool's free-page headroom above
its reserve (``kv_free_headroom()``) and the degradation watchdog. Any
signal over its threshold pauses consumption (``pause()`` on brokers
that have one; otherwise the lane stops pulling and counts the pause in
``app_pubsub_consumer_paused_total{topic,reason}``) and it resumes with
hysteresis (``resume_depth < pause_depth``). The in-flight semaphore
bounds the host queue to ``max_inflight`` jobs.

Lifecycle mirrors the engine: ``start()`` spawns the consumer loop,
``drain()`` stops pulling and waits for in-flight jobs, ``stop()``
drains then cancels stragglers.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
from typing import Any, Callable, Dict, Optional, Set

from gofr_tpu_torch.aio import spawn_logged
from gofr_tpu_torch.slo import STATE_DEGRADED
from gofr_tpu_torch.tpu import faults
from gofr_tpu_torch.tpu.generate import Sampling
from gofr_tpu_torch.trace import extract_traceparent

# how much of a malformed payload rides along in the dead-letter
# envelope — enough to debug, bounded so one 10MB blob can't amplify
_DEAD_LETTER_PAYLOAD_CAP = 4096

PAUSE_ADMISSION = "admission_depth"
PAUSE_KV_PAGES = "kv_pages"
PAUSE_DEGRADED = "degraded"


class JobError(ValueError):
    """A job this lane will never be able to run (parse/validation)."""


class BatchLane:
    """Subscriber-driven generation lane over one pub/sub topic."""

    def __init__(self, engine: Any, broker: Any, topic: str, *,
                 result_topic: Optional[str] = None,
                 dead_letter_topic: Optional[str] = None,
                 max_inflight: int = 8,
                 pause_depth: int = 64,
                 resume_depth: int = 16,
                 page_low_watermark: int = 0,
                 poll_s: float = 0.05,
                 default_max_new_tokens: int = 32,
                 encode: Optional[Callable[[str], list]] = None,
                 decode: Optional[Callable[[list], str]] = None,
                 watchdog: Any = None,
                 logger=None, metrics=None, tracer=None):
        if not topic:
            raise ValueError("BatchLane needs a topic")
        if resume_depth >= pause_depth:
            raise ValueError(
                f"resume_depth {resume_depth} must be < pause_depth "
                f"{pause_depth} (hysteresis)")
        # ``engine`` may be a GenerationEngine or a ModelRegistry — the
        # registry duck-types route(); jobs carry an optional "model"
        self._engine = engine
        self._broker = broker
        self.topic = str(topic)
        self.result_topic = result_topic or f"{self.topic}.results"
        self.dead_letter_topic = (dead_letter_topic
                                  or f"{self.topic}.dead-letter")
        self.max_inflight = int(max_inflight)
        self.pause_depth = int(pause_depth)
        self.resume_depth = int(resume_depth)
        self.page_low_watermark = int(page_low_watermark)
        self.poll_s = float(poll_s)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self._encode = encode
        self._decode = decode
        self.watchdog = watchdog
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self._sem = asyncio.Semaphore(self.max_inflight)
        self._jobs: Set[asyncio.Task] = set()
        self._task: Optional[asyncio.Task] = None
        self._draining = False
        self._paused = False
        self.jobs_ok = 0
        self.jobs_dead_lettered = 0
        self.pauses = 0
        self.resumes = 0

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> None:
        """Spawn the consumer loop (idempotent)."""
        if self._task is not None and not self._task.done():
            return
        self._draining = False
        self._task = spawn_logged(
            self._consume_loop(), self.logger,
            f"tpu.batch_lane.{self.topic}", metrics=self.metrics)

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop pulling new jobs, wait for in-flight ones. Returns True
        when everything landed within the timeout."""
        self._draining = True
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
        deadline = time.monotonic() + timeout_s
        while self._jobs and time.monotonic() < deadline:
            await asyncio.sleep(min(self.poll_s, 0.05))
        return not self._jobs

    async def stop(self, grace_s: float = 10.0) -> None:
        """Drain, then cancel whatever refused to land."""
        if not await self.drain(grace_s):
            for job in list(self._jobs):
                job.cancel()
            if self._jobs:
                await asyncio.gather(*self._jobs, return_exceptions=True)
            if self.logger is not None:
                self.logger.warn(
                    "batch lane %s: cancelled in-flight jobs at stop",
                    self.topic)

    # -- consumer loop ------------------------------------------------------
    async def _consume_loop(self) -> None:
        while not self._draining:
            await self._backpressure_gate()
            if self._draining:
                return
            try:
                message = await self._broker.subscribe(self.topic)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if self.logger is not None:
                    self.logger.error(
                        "batch lane %s receive error: %r", self.topic, exc)
                await asyncio.sleep(1.0)
                continue
            if message is None:  # broker closed
                return
            # the semaphore is the host-queue bound: at most max_inflight
            # jobs buffered/decoding — a flooded topic cannot OOM us
            await self._sem.acquire()
            task = asyncio.ensure_future(self._run_job(message))
            self._jobs.add(task)
            task.add_done_callback(self._job_done)
            self._set_inflight()

    def _job_done(self, task: asyncio.Task) -> None:
        self._jobs.discard(task)
        self._sem.release()
        self._set_inflight()
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None and self.logger is not None:
            # _run_job dead-letters its own failures; reaching here means
            # the error envelope itself failed — log, keep consuming
            self.logger.error("batch lane %s job task died: %r",
                              self.topic, exc)

    def _set_inflight(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_batch_lane_inflight",
                                   float(len(self._jobs)), topic=self.topic)

    # -- backpressure -------------------------------------------------------
    def _route(self, model: Optional[str] = None):
        route = getattr(self._engine, "route", None)
        if route is not None:
            return route(model or None)
        return self._engine

    def _observe_engine(self):
        """The engine whose admission/KV state gates consumption — the
        registry's default route, or the engine itself. None when the
        registry cannot serve at all (treated as DEGRADED-equivalent)."""
        try:
            return self._route(None)
        except Exception:
            return None

    def _pause_reason(self) -> Optional[str]:
        engine = self._observe_engine()
        if engine is None:
            return PAUSE_DEGRADED
        depth_fn = getattr(engine, "admission_depth", None)
        if depth_fn is not None and depth_fn() >= self.pause_depth:
            return PAUSE_ADMISSION
        headroom_fn = getattr(engine, "kv_free_headroom", None)
        if headroom_fn is not None:
            headroom = headroom_fn()
            if headroom is not None and headroom <= self.page_low_watermark:
                return PAUSE_KV_PAGES
        if (self.watchdog is not None
                and getattr(self.watchdog, "state", None) == STATE_DEGRADED):
            return PAUSE_DEGRADED
        return None

    def _may_resume(self) -> bool:
        engine = self._observe_engine()
        if engine is None:
            return False
        depth_fn = getattr(engine, "admission_depth", None)
        if depth_fn is not None and depth_fn() > self.resume_depth:
            return False
        headroom_fn = getattr(engine, "kv_free_headroom", None)
        if headroom_fn is not None:
            headroom = headroom_fn()
            if headroom is not None and headroom <= self.page_low_watermark:
                return False
        if (self.watchdog is not None
                and getattr(self.watchdog, "state", None) == STATE_DEGRADED):
            return False
        return True

    async def _backpressure_gate(self) -> None:
        reason = self._pause_reason()
        if reason is None:
            return
        self._paused = True
        self.pauses += 1
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_batch_lane_paused", 1.0,
                                   topic=self.topic)
        # brokers with a real fetcher pause (kafka) stop their prefetch
        # and count the pause themselves; everything else just has this
        # loop stop pulling, so the lane owns the counter
        pause = getattr(self._broker, "pause", None)
        if pause is not None:
            pause(self.topic, reason=reason)
        elif self.metrics is not None:
            self.metrics.increment_counter(
                "app_pubsub_consumer_paused_total",
                topic=self.topic, reason=reason)
        if self.logger is not None:
            self.logger.warn("batch lane %s paused (%s)", self.topic, reason)
        while not self._draining:
            await asyncio.sleep(self.poll_s)
            if self._may_resume():
                break
        self._paused = False
        self.resumes += 1
        if self.metrics is not None:
            self.metrics.set_gauge("app_tpu_batch_lane_paused", 0.0,
                                   topic=self.topic)
        resume = getattr(self._broker, "resume", None)
        if resume is not None:
            resume(self.topic)
        if self.logger is not None and not self._draining:
            self.logger.info("batch lane %s resumed", self.topic)

    @property
    def paused(self) -> bool:
        return self._paused

    # -- per-job path -------------------------------------------------------
    def _parse(self, payload: bytes) -> Dict[str, Any]:
        try:
            data = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as exc:
            raise JobError(f"job is not JSON: {exc}") from exc
        if not isinstance(data, dict):
            raise JobError(f"job must be a JSON object, got "
                           f"{type(data).__name__}")
        if "prompt_ids" in data:
            ids = data["prompt_ids"]
            if (not isinstance(ids, list)
                    or not all(isinstance(t, int) for t in ids)):
                raise JobError("prompt_ids must be a list of ints")
            prompt_ids = ids
        elif "prompt" in data:
            if self._encode is None:
                raise JobError(
                    "text prompts need a tokenizer on this lane; "
                    "send prompt_ids")
            prompt_ids = self._encode(str(data["prompt"]))
        else:
            raise JobError("job needs prompt_ids or prompt")
        try:
            max_new = int(data.get("max_new_tokens",
                                   self.default_max_new_tokens))
            eos_raw = data.get("eos_id")
            eos_id = int(eos_raw) if eos_raw is not None else None
            sampling_raw = data.get("sampling") or {}
            if not isinstance(sampling_raw, dict):
                raise JobError("sampling must be an object")
            seed = sampling_raw.get("seed")
            sampling = Sampling(
                temperature=float(sampling_raw.get("temperature", 0.0)),
                top_k=int(sampling_raw.get("top_k", 0)),
                top_p=float(sampling_raw.get("top_p", 1.0)),
                seed=int(seed) if seed is not None else None)
        except (TypeError, ValueError) as exc:
            raise JobError(f"bad field value: {exc}") from exc
        response_format = data.get("response_format")
        if response_format is not None and not isinstance(response_format,
                                                          dict):
            raise JobError("response_format must be an object")
        return {
            "id": str(data.get("id", "")),
            "prompt_ids": prompt_ids,
            "max_new_tokens": max_new,
            "eos_id": eos_id,
            "sampling": sampling,
            "response_format": response_format,
            "model": data.get("model"),
            "result_topic": data.get("result_topic"),
        }

    async def _publish(self, topic: str, payload: Dict[str, Any]) -> None:
        # chaos site: a dropped broker publish sends the
        # result down the dead-letter path (and a dropped dead-letter
        # publish is logged and swallowed) — the job commits either
        # way, so one flaky broker can never wedge the partition
        faults.active().raise_if("broker_drop")
        body = json.dumps(payload).encode("utf-8")
        result = self._broker.publish(topic, body)
        if asyncio.iscoroutine(result):
            await result

    async def _dead_letter(self, job_id: str, payload: bytes,
                           exc: BaseException) -> None:
        self.jobs_dead_lettered += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_tpu_batch_lane_jobs_total", outcome="dead_letter")
        if self.logger is not None:
            self.logger.error("batch lane %s job %s dead-lettered: %r",
                              self.topic, job_id or "<unknown>", exc)
        envelope = {
            "id": job_id or None,
            "error": {"type": type(exc).__name__, "message": str(exc)},
            "job": payload[:_DEAD_LETTER_PAYLOAD_CAP].decode(
                "utf-8", errors="replace"),
        }
        try:
            await self._publish(self.dead_letter_topic, envelope)
        except Exception as pub_exc:
            if self.logger is not None:
                self.logger.error(
                    "batch lane %s dead-letter publish failed: %r",
                    self.topic, pub_exc)

    async def _run_job(self, message: Any) -> None:
        # per-job consume span, continuing the producer's trace when the
        # broker carried a traceparent; held open across generation so
        # the result publish span lands inside it (contextvar parenting)
        remote = extract_traceparent(message.header("traceparent") or "")
        if self.tracer is not None:
            span_ctx = self.tracer.start_span("pubsub.consume",
                                              remote_parent=remote)
        else:
            span_ctx = contextlib.nullcontext()
        payload = message.value if isinstance(message.value, bytes) \
            else str(message.value).encode("utf-8")
        with span_ctx as span:
            if span is not None:
                span.set_attribute("topic", self.topic)
                span.set_attribute("lane", "batch")
            job_id = ""
            try:
                job = self._parse(payload)
                job_id = job["id"]
                engine = self._route(job["model"])
                start = getattr(engine, "start", None)
                if start is not None:
                    # idempotent; binds the serving loop on first use —
                    # apps start engines lazily (HTTP handlers do the
                    # same), so a lane job may be the first request in
                    await start()
                # no deadline on this task → deadline_class(None) files
                # the request under the WFQ "batch" class
                tokens = await engine.generate(
                    job["prompt_ids"],
                    max_new_tokens=job["max_new_tokens"],
                    eos_id=job["eos_id"],
                    sampling=job["sampling"],
                    response_format=job["response_format"])
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if span is not None:
                    span.set_status("ERROR")
                if not job_id:
                    # best-effort id for the envelope even when the job
                    # failed validation after the JSON layer parsed
                    with contextlib.suppress(Exception):
                        raw = json.loads(payload.decode("utf-8"))
                        if isinstance(raw, dict):
                            job_id = str(raw.get("id", ""))
                await self._dead_letter(job_id, payload, exc)
                message.commit()
                return
            finish = "length"
            if len(tokens) < job["max_new_tokens"] or (
                    job["eos_id"] is not None and tokens
                    and tokens[-1] == job["eos_id"]):
                finish = "stop"
            result: Dict[str, Any] = {
                "id": job_id,
                "model": getattr(engine, "model_name", "generate"),
                "tokens": tokens,
                "finish_reason": finish,
                "usage": {
                    "prompt_tokens": len(job["prompt_ids"]),
                    "completion_tokens": len(tokens),
                    "total_tokens": len(job["prompt_ids"]) + len(tokens),
                },
            }
            if self._decode is not None:
                try:
                    result["text"] = self._decode(tokens)
                except Exception:
                    pass  # tokens are the contract; text is sugar
            try:
                await self._publish(job.get("result_topic")
                                    or self.result_topic, result)
            except Exception as exc:
                if span is not None:
                    span.set_status("ERROR")
                await self._dead_letter(job_id, payload, exc)
                message.commit()
                return
            self.jobs_ok += 1
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_tpu_batch_lane_jobs_total", outcome="ok")
            message.commit()

    # -- observability ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "topic": self.topic,
            "result_topic": self.result_topic,
            "dead_letter_topic": self.dead_letter_topic,
            "inflight": len(self._jobs),
            "max_inflight": self.max_inflight,
            "paused": self._paused,
            "draining": self._draining,
            "jobs_ok": self.jobs_ok,
            "jobs_dead_lettered": self.jobs_dead_lettered,
            "pauses": self.pauses,
            "resumes": self.resumes,
            "pause_depth": self.pause_depth,
            "resume_depth": self.resume_depth,
            "page_low_watermark": self.page_low_watermark,
        }


def new_batch_lane(config, engine, container, *,
                   encode: Optional[Callable[[str], list]] = None,
                   decode: Optional[Callable[[list], str]] = None
                   ) -> Optional[BatchLane]:
    """Config-driven constructor: None unless ``BATCH_LANE_TOPIC`` is set
    and a broker + engine are wired. Knob catalog in
    docs/quick-start/configuration.md; ``container`` is duck-typed
    (``pubsub``, ``watchdog``, ``logger``, ``metrics``, ``tracer``)."""
    topic = config.get("BATCH_LANE_TOPIC")
    if not topic or container.pubsub is None or engine is None:
        return None
    return BatchLane(
        engine, container.pubsub, topic,
        result_topic=config.get("BATCH_LANE_RESULT_TOPIC"),
        dead_letter_topic=config.get("BATCH_LANE_DEAD_TOPIC"),
        max_inflight=config.get_int("BATCH_LANE_MAX_INFLIGHT", 8),
        pause_depth=config.get_int("BATCH_LANE_PAUSE_DEPTH", 64),
        resume_depth=config.get_int("BATCH_LANE_RESUME_DEPTH", 16),
        page_low_watermark=config.get_int(
            "BATCH_LANE_PAGE_LOW_WATERMARK", 0),
        poll_s=config.get_float("BATCH_LANE_POLL_S", 0.05),
        default_max_new_tokens=config.get_int(
            "BATCH_LANE_DEFAULT_MAX_NEW_TOKENS", 32),
        encode=encode, decode=decode,
        watchdog=container.watchdog,
        logger=container.logger, metrics=container.metrics,
        tracer=container.tracer)


__all__ = ["BatchLane", "JobError", "new_batch_lane",
           "PAUSE_ADMISSION", "PAUSE_KV_PAGES", "PAUSE_DEGRADED"]
