"""Google Cloud Pub/Sub backend, gated on ``google-cloud-pubsub`` (a
copy of ``gofr_tpu/datasource/pubsub/google.py``). Without the package,
construction raises :class:`GoogleClientError`; with it, publish,
streaming-pull subscribe into a local queue, topic admin and health.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSub


class GoogleClientError(Exception):
    pass


class GoogleClient(PubSub):
    def __init__(self, config, logger, metrics, tracer=None):
        try:
            from google.cloud import pubsub_v1
        except ImportError as exc:
            raise GoogleClientError(
                "PUBSUB_BACKEND=GOOGLE requires google-cloud-pubsub, which "
                "is not installed in this image; use KAFKA, MQTT, or INMEM"
            ) from exc
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.project = config.get("GOOGLE_PROJECT_ID")
        if not self.project:
            raise GoogleClientError("GOOGLE_PROJECT_ID is required")
        self.subscription_name = config.get_or_default(
            "GOOGLE_SUBSCRIPTION_NAME", "gofr-tpu")
        self._publisher = pubsub_v1.PublisherClient()
        self._subscriber = pubsub_v1.SubscriberClient()
        self._queues = {}
        self._pulls = {}
        self._lock = threading.Lock()
        logger.info("google pub/sub connected project=%s", self.project)

    def _topic_path(self, topic: str) -> str:
        return self._publisher.topic_path(self.project, topic)

    def publish(self, topic: str, payload: bytes, key: bytes = b"") -> None:
        self.metrics.increment_counter("app_pubsub_publish_total_count",
                                       topic=topic)
        # Pub/Sub has native message attributes, so the traceparent rides
        # as one (no byte envelope needed, unlike Kafka/MQTT). The
        # subscriber callback lifts it back into Message.metadata.
        attrs = {"key": key.decode() if key else ""}
        span = None
        if self.tracer is not None:
            from gofr_tpu_torch.trace import current_span, format_traceparent
            if current_span() is not None:
                span = self.tracer.start_span("pubsub.publish")
                span.set_attribute("topic", topic)
                span.set_attribute("backend", "GOOGLE")
                attrs["traceparent"] = format_traceparent(span)
        try:
            future = self._publisher.publish(self._topic_path(topic),
                                             payload, **attrs)
            future.result(timeout=30)
        except Exception:
            if span is not None:
                span.set_status("ERROR")
            raise
        finally:
            if span is not None:
                span.finish()
        self.metrics.increment_counter("app_pubsub_publish_success_count",
                                       topic=topic)

    def _ensure_pull(self, topic: str) -> "queue.Queue":
        with self._lock:
            if topic in self._queues:
                return self._queues[topic]
            local = queue.Queue(maxsize=65536)
            self._queues[topic] = local
            sub_path = self._subscriber.subscription_path(
                self.project, f"{self.subscription_name}-{topic}")
            try:
                self._subscriber.create_subscription(
                    request={"name": sub_path,
                             "topic": self._topic_path(topic)})
            except Exception:
                pass  # already exists

            def callback(received):
                attrs = dict(getattr(received, "attributes", None) or {})
                traceparent = attrs.get("traceparent")
                metadata = ({"traceparent": traceparent}
                            if traceparent else None)
                local.put(Message(topic, received.data, metadata=metadata,
                                  committer=received.ack))

            self._pulls[topic] = self._subscriber.subscribe(sub_path,
                                                            callback)
            return local

    async def subscribe(self, topic: str) -> Optional[Message]:
        import asyncio
        self.metrics.increment_counter("app_pubsub_subscribe_total_count",
                                       topic=topic)
        local = self._ensure_pull(topic)
        message = await asyncio.get_running_loop().run_in_executor(
            None, local.get)
        if message is not None:
            self.metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=topic)
        return message

    def create_topic(self, topic: str) -> None:
        try:
            self._publisher.create_topic(
                request={"name": self._topic_path(topic)})
        except Exception:
            pass  # already exists

    def delete_topic(self, topic: str) -> None:
        self._publisher.delete_topic(
            request={"topic": self._topic_path(topic)})

    def health_check(self) -> dict:
        try:
            self._publisher.list_topics(
                request={"project": f"projects/{self.project}",
                         "page_size": 1})
            return {"status": "UP", "details": {"backend": "GOOGLE",
                                                "project": self.project}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def close(self) -> None:
        for pull in self._pulls.values():
            pull.cancel()
