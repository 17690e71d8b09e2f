"""The pub/sub contract (a copy of the part of
``gofr_tpu/datasource/pubsub/base.py`` the batch lane and the in-memory
broker use): a received :class:`Message` with its headers and commit,
and the :class:`PubSub` client surface."""

from __future__ import annotations

from typing import Any, Dict, Optional


class Message:
    """A received message: its topic, payload bytes, key, headers, and
    the commit that acknowledges it."""

    __slots__ = ("topic", "value", "key", "metadata", "_committer",
                 "committed")

    def __init__(self, topic: str, value: bytes, key: bytes = b"",
                 metadata: Optional[Dict[str, Any]] = None, committer=None):
        self.topic = topic
        self.value = value
        self.key = key
        self.metadata = metadata or {}
        self._committer = committer
        self.committed = False

    def header(self, key: str) -> str:
        return str(self.metadata.get(key, ""))

    def commit(self) -> None:
        if self._committer is not None and not self.committed:
            self._committer()
        self.committed = True


class PubSub:
    """Client contract: publisher, subscriber, topic admin, health."""

    def publish(self, topic: str, payload: bytes, key: bytes = b"") -> None:
        raise NotImplementedError

    async def subscribe(self, topic: str) -> Optional[Message]:
        """Blocking receive of one message from the topic (None on backend
        shutdown)."""
        raise NotImplementedError

    def create_topic(self, topic: str) -> None:
        raise NotImplementedError

    def delete_topic(self, topic: str) -> None:
        raise NotImplementedError

    def health_check(self) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        pass
