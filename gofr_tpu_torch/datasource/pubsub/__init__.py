"""Pub/sub: the ``Message`` / ``PubSub`` contract and the in-memory
broker (counterpart of ``gofr_tpu/datasource/pubsub``)."""

from gofr_tpu_torch.datasource.pubsub.base import Message, PubSub
from gofr_tpu_torch.datasource.pubsub.inmem import InMemoryBroker

__all__ = ["InMemoryBroker", "Message", "PubSub"]
