"""MQTT 3.1.1 backend (a copy of ``gofr_tpu/datasource/pubsub/mqtt.py``):
a wire client on the stdlib's sockets, no driver. CONNECT / CONNACK,
PUBLISH at QoS 0 and 1, SUBSCRIBE / SUBACK, PINGREQ keepalive and
DISCONNECT.

One reader thread decodes packets and fans PUBLISHes out to per-topic
queues; ``subscribe`` awaits a queue through the default executor, so the
event loop never blocks. A dead reader (a broker restart, a dropped
connection) turns into a reconnect loop with exponential backoff that
subscribes every known topic again.

MQTT 3.1.1 has no user properties, so when a span is active at publish
the W3C traceparent rides in the byte envelope of ``base.py`` (Kafka's
carrier too), and the reader surfaces it as message metadata. An
untraced publish keeps the payload's bytes as they are.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from gofr_tpu_torch.datasource.pubsub.base import (Message, PubSub,
                                             decode_trace_envelope,
                                             encode_trace_envelope)

# packet types << 4
CONNECT, CONNACK = 0x10, 0x20
PUBLISH, PUBACK = 0x30, 0x40
SUBSCRIBE, SUBACK = 0x82, 0x90  # SUBSCRIBE requires flags 0b0010
UNSUBSCRIBE = 0xA2
PINGREQ, PINGRESP = 0xC0, 0xD0
DISCONNECT = 0xE0

DEFAULT_PUBLIC_BROKER = "broker.hivemq.com"  # mqtt.go:19-22


class MQTTError(Exception):
    pass


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        digit = n % 128
        n //= 128
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _encode_string(s: str) -> bytes:
    raw = s.encode()
    return struct.pack(">H", len(raw)) + raw


def encode_connect(client_id: str, keepalive: int, username: str = "",
                   password: str = "", clean: bool = True) -> bytes:
    flags = 0x02 if clean else 0x00
    payload = _encode_string(client_id)
    if username:
        flags |= 0x80
        payload += _encode_string(username)
        if password:
            flags |= 0x40
            payload += _encode_string(password)
    var_header = (_encode_string("MQTT") + bytes([4, flags])
                  + struct.pack(">H", keepalive))
    body = var_header + payload
    return bytes([CONNECT]) + _encode_varint(len(body)) + body


def encode_publish(topic: str, payload: bytes, packet_id: int = 0,
                   qos: int = 0, retain: bool = False) -> bytes:
    header = PUBLISH | (qos << 1) | (1 if retain else 0)
    body = _encode_string(topic)
    if qos > 0:
        body += struct.pack(">H", packet_id)
    body += payload
    return bytes([header]) + _encode_varint(len(body)) + body


def encode_subscribe(packet_id: int, topic: str, qos: int = 0) -> bytes:
    body = struct.pack(">H", packet_id) + _encode_string(topic) + bytes([qos])
    return bytes([SUBSCRIBE]) + _encode_varint(len(body)) + body


def decode_publish(flags: int, body: bytes) -> Tuple[str, bytes, int, int]:
    """→ (topic, payload, qos, packet_id)."""
    qos = (flags >> 1) & 0x03
    topic_len = struct.unpack_from(">H", body, 0)[0]
    topic = body[2:2 + topic_len].decode()
    offset = 2 + topic_len
    packet_id = 0
    if qos > 0:
        packet_id = struct.unpack_from(">H", body, offset)[0]
        offset += 2
    return topic, body[offset:], qos, packet_id


class MQTTClient(PubSub):
    def __init__(self, config, logger, metrics, tracer=None):
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.host = config.get_or_default("MQTT_HOST", DEFAULT_PUBLIC_BROKER)
        self.port = config.get_int("MQTT_PORT", 1883)
        self.qos = config.get_int("MQTT_QOS", 0)
        self.keepalive = config.get_int("MQTT_KEEPALIVE", 30)
        self.client_id = config.get_or_default(
            "MQTT_CLIENT_ID", f"gofr-tpu-{int(time.time())}")
        self._username = config.get_or_default("MQTT_USER", "")
        self._password = config.get_or_default("MQTT_PASSWORD", "")
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._packet_id = 0
        self._queues: Dict[str, "queue.Queue[Optional[Message]]"] = {}
        self._subscribed: Dict[str, bool] = {}
        self._connected = threading.Event()
        # single-reconnector guard: a failed redial can orphan a reader
        # thread whose own death must not start a second reconnect loop
        self._reconnecting = threading.Lock()
        self._closed = False
        self._connect()

    # -- connection ---------------------------------------------------------
    def _connect(self) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=10.0)
        self._sock.sendall(encode_connect(self.client_id, self.keepalive,
                                          self._username, self._password))
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="mqtt-reader")
        self._reader.start()
        if not self._connected.wait(10.0):
            raise MQTTError("CONNACK timeout")
        self._pinger = threading.Thread(target=self._ping_loop, daemon=True,
                                        name="mqtt-ping")
        self._pinger.start()
        for topic in list(self._subscribed):
            self._send_subscribe(topic)
        self.logger.info("mqtt connected %s:%d as %s", self.host, self.port,
                         self.client_id)

    def _next_packet_id(self) -> int:
        with self._lock:
            self._packet_id = (self._packet_id % 65535) + 1
            return self._packet_id

    def _send(self, data: bytes) -> None:
        with self._lock:
            if self._sock is None:
                raise MQTTError("not connected")
            self._sock.sendall(data)

    def _ping_loop(self) -> None:
        interval = max(5, self.keepalive // 2)
        while not self._closed:
            time.sleep(interval)
            try:
                self._send(bytes([PINGREQ, 0]))
            except Exception:
                return

    # -- packet reader ------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = self._sock.recv(n - len(data))
            if not chunk:
                raise MQTTError("connection closed")
            data += chunk
        return data

    def _read_varint(self) -> int:
        value, multiplier = 0, 1
        while True:
            byte = self._read_exact(1)[0]
            value += (byte & 0x7F) * multiplier
            if not byte & 0x80:
                return value
            multiplier *= 128

    def _read_loop(self) -> None:
        try:
            while not self._closed:
                first = self._read_exact(1)[0]
                length = self._read_varint()
                body = self._read_exact(length) if length else b""
                self._on_packet(first, body)
        except Exception as exc:
            if self._closed:
                return
            # dead reader ≠ dead client: reconnect with backoff and
            # re-subscribe every known topic (see _connect). Only a
            # deliberate close() terminates subscribers with the None
            # sentinel — a broker restart must be invisible to them.
            if not self._reconnecting.acquire(blocking=False):
                return  # another (newer) reader already owns recovery
            try:
                self.logger.error("mqtt reader died (reconnecting): %r",
                                  exc)
                self._connected.clear()
                self._close_sock()
                self._reconnect_loop()
            finally:
                self._reconnecting.release()

    def _close_sock(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _reconnect_loop(self) -> None:
        """Runs on the dying reader thread: redial until the broker is
        back (or close()), then hand off to the fresh reader ``_connect``
        spawns. ``_connect`` re-subscribes ``self._subscribed``, so every
        topic registered before the outage keeps flowing."""
        backoff = 0.5
        while not self._closed:
            try:
                self._connect()
                return
            except Exception as exc:
                self._close_sock()  # orphan a half-open dial cleanly
                self.logger.warn(
                    "mqtt reconnect to %s:%d failed (retrying in %.1fs): "
                    "%r", self.host, self.port, backoff, exc)
                deadline = time.monotonic() + backoff
                while not self._closed \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                backoff = min(backoff * 2, 30.0)

    def _on_packet(self, first: int, body: bytes) -> None:
        packet_type = first & 0xF0
        if packet_type == CONNACK:
            if len(body) >= 2 and body[1] == 0:
                self._connected.set()
            else:
                self.logger.error("mqtt CONNACK refused: %r", body)
            return
        if packet_type == PUBLISH:
            topic, payload, qos, packet_id = decode_publish(first & 0x0F,
                                                            body)
            if qos == 1:
                self._send(bytes([PUBACK, 2]) + struct.pack(">H", packet_id))
            traceparent, payload = decode_trace_envelope(payload)
            metadata = {"traceparent": traceparent} if traceparent else None
            message = Message(topic, payload, metadata=metadata,
                              committer=lambda: None)
            self._topic_queue(topic).put(message)
            return
        # SUBACK / PUBACK / PINGRESP need no action for QoS ≤ 1

    # -- PubSub contract ----------------------------------------------------
    def _topic_queue(self, topic: str) -> "queue.Queue":
        q = self._queues.get(topic)
        if q is None:
            q = queue.Queue(maxsize=65536)
            self._queues[topic] = q
        return q

    def _send_subscribe(self, topic: str) -> None:
        self._send(encode_subscribe(self._next_packet_id(), topic, self.qos))

    def publish(self, topic: str, payload: bytes, key: bytes = b"") -> None:
        self.metrics.increment_counter("app_pubsub_publish_total_count",
                                       topic=topic)
        # MQTT 3.1.1 has no user properties, so an in-flight trace rides
        # in the opt-in byte envelope (base.py). Publishes outside a span
        # keep the wire payload byte-for-byte unchanged.
        span = None
        if self.tracer is not None:
            from gofr_tpu_torch.trace import current_span, format_traceparent
            if current_span() is not None:
                span = self.tracer.start_span("pubsub.publish")
                span.set_attribute("topic", topic)
                span.set_attribute("backend", "MQTT")
                payload = encode_trace_envelope(format_traceparent(span),
                                                payload)
        try:
            packet_id = self._next_packet_id() if self.qos else 0
            self._send(encode_publish(topic, payload, packet_id, self.qos))
        except Exception:
            if span is not None:
                span.set_status("ERROR")
            raise
        finally:
            if span is not None:
                span.finish()
        self.metrics.increment_counter("app_pubsub_publish_success_count",
                                       topic=topic)

    async def subscribe(self, topic: str) -> Optional[Message]:
        import asyncio
        if topic not in self._subscribed:
            self._subscribed[topic] = True
            self._send_subscribe(topic)
        self.metrics.increment_counter("app_pubsub_subscribe_total_count",
                                       topic=topic)
        q = self._topic_queue(topic)
        message = await asyncio.get_running_loop().run_in_executor(
            None, q.get)
        if message is not None:
            self.metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=topic)
        return message

    def create_topic(self, topic: str) -> None:
        pass  # MQTT topics are implicit

    def delete_topic(self, topic: str) -> None:
        self._queues.pop(topic, None)

    def health_check(self) -> dict:
        up = self._connected.is_set() and not self._closed
        return {"status": "UP" if up else "DOWN",
                "details": {"backend": "MQTT",
                            "host": f"{self.host}:{self.port}",
                            "client_id": self.client_id}}

    def close(self) -> None:
        self._closed = True
        try:
            if self._sock is not None:
                self._sock.sendall(bytes([DISCONNECT, 0]))
                self._sock.close()
        except Exception:
            pass
        for q in self._queues.values():
            q.put(None)
