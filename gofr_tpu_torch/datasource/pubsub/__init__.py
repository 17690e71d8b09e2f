"""Pub/sub (counterpart of ``gofr_tpu/datasource/pubsub``): the
``Message`` / ``PubSub`` contract and ``new_pubsub``, the backend switch
of ``PUBSUB_BACKEND``:

- ``INMEM`` (or ``MEMORY``): the in-process broker;
- ``MQTT``: the MQTT 3.1.1 wire client;
- ``KAFKA``: the Kafka wire-protocol client;
- ``GOOGLE``: Google Cloud Pub/Sub, gated on ``google-cloud-pubsub``.
"""

from __future__ import annotations

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSub
from gofr_tpu_torch.datasource.pubsub.inmem import InMemoryBroker

__all__ = ["InMemoryBroker", "Message", "PubSub", "new_pubsub"]


def new_pubsub(backend: str, config, logger, metrics, tracer=None) -> PubSub:
    """The client ``PUBSUB_BACKEND`` names, built from ``config``."""
    backend = backend.upper()
    if backend in ("INMEM", "MEMORY"):
        return InMemoryBroker(logger, metrics, tracer=tracer)
    if backend == "MQTT":
        from gofr_tpu_torch.datasource.pubsub.mqtt import MQTTClient
        return MQTTClient(config, logger, metrics, tracer=tracer)
    if backend == "KAFKA":
        from gofr_tpu_torch.datasource.pubsub.kafka import KafkaClient
        return KafkaClient(config, logger, metrics, tracer=tracer)
    if backend == "GOOGLE":
        from gofr_tpu_torch.datasource.pubsub.google import GoogleClient
        return GoogleClient(config, logger, metrics, tracer=tracer)
    raise ValueError(f"unknown PUBSUB_BACKEND {backend!r}")
