"""In-process pub/sub broker (a copy of
``gofr_tpu/datasource/pubsub/inmem.py``).

Topics are asyncio queues; a consumer group sees each message once (a
Kafka consumer group with one partition). ``publish`` runs inside a
``pubsub.publish`` span when a tracer is given and carries its W3C
``traceparent`` as a message header, which ``subscribe`` surfaces
through ``Message.header("traceparent")``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from gofr_tpu_torch.datasource import UP, health
from gofr_tpu_torch.datasource.pubsub.base import Message, PubSub
from gofr_tpu_torch.trace import format_traceparent


class InMemoryBroker(PubSub):
    def __init__(self, logger=None, metrics=None, maxsize: int = 65536,
                 tracer=None):
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.maxsize = maxsize
        self._queues: Dict[str, asyncio.Queue] = {}
        self._published = 0
        self._delivered = 0
        self._closed = False

    def _queue(self, topic: str) -> asyncio.Queue:
        queue = self._queues.get(topic)
        if queue is None:
            queue = asyncio.Queue(maxsize=self.maxsize)
            self._queues[topic] = queue
        return queue

    def publish(self, topic: str, payload: bytes, key: bytes = b"") -> None:
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_publish_total_count",
                                           topic=topic)
        headers: Dict[str, str] = {}
        span = None
        if self.tracer is not None:
            span = self.tracer.start_span("pubsub.publish")
            span.set_attribute("topic", topic)
            span.set_attribute("backend", "INMEM")
            headers["traceparent"] = format_traceparent(span)
        try:
            self._queue(topic).put_nowait((payload, key, headers))
            self._published += 1
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_pubsub_publish_success_count", topic=topic)
        except asyncio.QueueFull:
            if span is not None:
                span.set_status("ERROR")
            if self.logger is not None:
                self.logger.error("inmem broker: topic %s full, dropping",
                                  topic)
        finally:
            if span is not None:
                span.finish()

    async def subscribe(self, topic: str) -> Optional[Message]:
        if self.metrics is not None:
            self.metrics.increment_counter("app_pubsub_subscribe_total_count",
                                           topic=topic)
        if self._closed:
            return None
        payload, key, headers = await self._queue(topic).get()
        self._delivered += 1
        if self.metrics is not None:
            self.metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=topic)
        return Message(topic, payload, key, metadata=dict(headers),
                       committer=lambda: None)

    def create_topic(self, topic: str) -> None:
        self._queue(topic)

    def delete_topic(self, topic: str) -> None:
        self._queues.pop(topic, None)

    def health_check(self) -> dict:
        return health(UP, backend="INMEM", topics=len(self._queues),
                      published=self._published, delivered=self._delivered)

    def close(self) -> None:
        self._closed = True
