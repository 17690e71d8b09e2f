"""The pub/sub contract (a copy of ``gofr_tpu/datasource/pubsub/base.py``):
the trace envelope that carries a W3C traceparent where the wire has no
headers, the received :class:`Message`, which doubles as a subscriber
handler's request (``param("topic")``, ``path_param``, scalar or JSON
``bind``, ``to_log``) and commits, and the :class:`PubSub` client
surface."""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Tuple

# -- trace-context envelope ---------------------------------------------------
# Kafka's message-set v1 wire format (datasource/pubsub/kafka.py) has no
# native record headers, so cross-service trace propagation uses a tiny
# opt-in byte envelope around the payload: MAGIC + uint16 traceparent
# length + traceparent + original payload. Applied only when a span is
# active at publish time; consumers that don't know the envelope still see
# a payload whose first bytes are the magic (never valid JSON/UTF-8 text),
# and gofr-tpu consumers unwrap it transparently.
_TRACE_MAGIC = b"\x00GTR1"


def encode_trace_envelope(traceparent: str, payload: bytes) -> bytes:
    """Wrap ``payload`` with a ``traceparent`` header (W3C string)."""
    header = traceparent.encode("ascii", "replace")
    return _TRACE_MAGIC + struct.pack(">H", len(header)) + header + payload


def decode_trace_envelope(raw: bytes) -> Tuple[Optional[str], bytes]:
    """Unwrap a trace envelope → (traceparent, payload). Non-enveloped
    input returns ``(None, raw)`` unchanged — safe on any byte stream."""
    if not raw.startswith(_TRACE_MAGIC):
        return None, raw
    offset = len(_TRACE_MAGIC)
    if len(raw) < offset + 2:
        return None, raw
    (length,) = struct.unpack_from(">H", raw, offset)
    offset += 2
    if len(raw) < offset + length:
        return None, raw
    header = raw[offset:offset + length].decode("ascii", "replace")
    return header, raw[offset + length:]


class Message:
    """A received message; doubles as the handler's ``request``."""

    __slots__ = ("topic", "value", "key", "metadata", "_committer", "committed")

    def __init__(self, topic: str, value: bytes, key: bytes = b"",
                 metadata: Optional[Dict[str, Any]] = None, committer=None):
        self.topic = topic
        self.value = value
        self.key = key
        self.metadata = metadata or {}
        self._committer = committer
        self.committed = False

    # -- Request contract (pubsub/message.go:35-107) ------------------------
    def param(self, key: str) -> str:
        if key == "topic":
            return self.topic
        return str(self.metadata.get(key, ""))

    def path_param(self, key: str) -> str:
        return self.param(key)

    def bind(self, target: Any = None) -> Any:
        """Scalar or JSON decode of the payload (message.go:60-107)."""
        text = self.value.decode("utf-8", "replace")
        if target is None:
            try:
                return json.loads(text)
            except ValueError:
                return text
        if target in (str,):
            return text
        if target in (int, float):
            return target(text.strip())
        try:
            data = json.loads(text)
        except ValueError as exc:
            raise ValueError(f"cannot bind message on {self.topic!r}") from exc
        from gofr_tpu_torch.http.request import _bind_into
        return _bind_into(target, data)

    def header(self, key: str) -> str:
        return str(self.metadata.get(key, ""))

    # -- Committer contract (interface.go:27-30) ----------------------------
    def commit(self) -> None:
        if self._committer is not None and not self.committed:
            self._committer()
        self.committed = True

    def to_log(self):
        return {"topic": self.topic, "bytes": len(self.value)}


class PubSub:
    """Client contract: Publisher + Subscriber + topic admin + health
    (interface.go:19-26)."""

    def publish(self, topic: str, payload: bytes, key: bytes = b"") -> None:
        raise NotImplementedError

    async def subscribe(self, topic: str) -> Optional[Message]:
        """Blocking receive of one message from the topic (returns None on
        backend shutdown)."""
        raise NotImplementedError

    def create_topic(self, topic: str) -> None:
        raise NotImplementedError

    def delete_topic(self, topic: str) -> None:
        raise NotImplementedError

    def health_check(self) -> dict:
        raise NotImplementedError

    def close(self) -> None:
        pass
