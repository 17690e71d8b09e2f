"""Kafka backend (a copy of ``gofr_tpu/datasource/pubsub/kafka.py``): a
wire-protocol client on the stdlib's sockets, no driver.

It speaks Metadata v1, Produce v2 (message-set v1 with CRC32), Fetch v2,
ListOffsets v1, OffsetFetch v1, OffsetCommit v2, CreateTopics v0,
DeleteTopics v0, and FindCoordinator, JoinGroup, SyncGroup, Heartbeat and
LeaveGroup v0.

Each subscribed topic runs a poller thread that is one member of the
consumer group: it joins through the coordinator, the elected leader
computes the range assignment, and the member fetches its partitions,
each on a fetcher thread of its own, heartbeats, and rebalances when the
membership changes. Two instances of a service in one group split a
topic's partitions, and a dead member's partitions go to the survivors.
``KAFKA_GROUP_MODE=static`` has every consumer fetch every partition
(for brokers without group coordination); offsets still live on the
broker. ``Message.commit()`` advances the group's offset, fenced by the
member's generation in group mode. ``pause`` / ``resume`` stop and
restart a topic's fetchers (the batch lane's backpressure) and count in
``app_pubsub_consumer_paused_total{topic,reason}``.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from gofr_tpu_torch.datasource.pubsub.base import (
    Message,
    PubSub,
    decode_trace_envelope,
    encode_trace_envelope,
)

API_PRODUCE, API_FETCH, API_LIST_OFFSETS, API_METADATA = 0, 1, 2, 3
API_OFFSET_COMMIT, API_OFFSET_FETCH = 8, 9
API_FIND_COORDINATOR, API_JOIN_GROUP = 10, 11
API_HEARTBEAT, API_LEAVE_GROUP, API_SYNC_GROUP = 12, 13, 14
API_CREATE_TOPICS, API_DELETE_TOPICS = 19, 20

# group-coordination error codes (Kafka protocol)
ERR_COORDINATOR_LOADING = 14
ERR_COORDINATOR_NOT_AVAILABLE = 15
ERR_NOT_COORDINATOR = 16
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER = 25
ERR_REBALANCE_IN_PROGRESS = 27


class KafkaError(Exception):
    pass


class KafkaOffsetOutOfRange(KafkaError):
    """Fetch error 1: committed offset expired (retention) or invalid —
    the consumer must reset to the earliest available offset."""


class KafkaRebalance(KafkaError):
    """Group membership changed (heartbeat/commit returned 22/25/27):
    the member must rejoin and resync its assignment. ``reset_member``
    means the coordinator no longer knows us (error 25) and the next
    join must request a fresh member id."""

    def __init__(self, message: str, reset_member: bool = False):
        super().__init__(message)
        self.reset_member = reset_member


# -- primitive codecs --------------------------------------------------------

def _string(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    raw = s.encode()
    return struct.pack(">h", len(raw)) + raw


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.offset = 0

    def int8(self):  return self._unpack(">b", 1)
    def int16(self): return self._unpack(">h", 2)
    def int32(self): return self._unpack(">i", 4)
    def int64(self): return self._unpack(">q", 8)

    def _unpack(self, fmt, size):
        value = struct.unpack_from(fmt, self.data, self.offset)[0]
        self.offset += size
        return value

    def string(self) -> Optional[str]:
        n = self.int16()
        if n == -1:
            return None
        raw = self.data[self.offset:self.offset + n]
        self.offset += n
        return raw.decode()

    def raw_bytes(self) -> Optional[bytes]:
        n = self.int32()
        if n == -1:
            return None
        raw = self.data[self.offset:self.offset + n]
        self.offset += n
        return raw


def encode_message_set(items: List[Tuple[bytes, bytes]]) -> bytes:
    """Message-set v1 (magic 1): [offset][size][crc][magic][attrs][ts][k][v]."""
    out = bytearray()
    timestamp = int(time.time() * 1000)
    for key, value in items:
        body = (struct.pack(">bbq", 1, 0, timestamp) + _bytes(key or None)
                + _bytes(value))
        crc = zlib.crc32(body) & 0xFFFFFFFF
        message = struct.pack(">I", crc) + body
        out += struct.pack(">q", 0) + struct.pack(">i", len(message)) + message
    return bytes(out)


def decode_message_set(data: bytes, queue_offset: int
                       ) -> List[Tuple[int, bytes, bytes]]:
    """→ [(offset, key, value)]; tolerates a truncated trailing message."""
    out: List[Tuple[int, bytes, bytes]] = []
    reader = _Reader(data)
    while reader.offset + 12 <= len(data):
        offset = reader.int64()
        size = reader.int32()
        if reader.offset + size > len(data):
            break
        end = reader.offset + size
        reader.int32()                       # crc (trusting TCP checksums)
        magic = reader.int8()
        attrs = reader.int8()
        if magic >= 1:
            reader.int64()                   # timestamp
        key = reader.raw_bytes() or b""
        value = reader.raw_bytes() or b""
        if attrs & 0x07:
            raise KafkaError("compressed message sets not supported")
        if offset >= queue_offset:
            out.append((offset, key, value))
        reader.offset = end
    return out


# -- consumer embedded protocol (range assignment) ---------------------------

def encode_consumer_metadata(topics: List[str]) -> bytes:
    """ConsumerProtocolSubscription v0: the member's topic list, carried
    inside JoinGroup so the elected leader can compute assignments."""
    out = struct.pack(">h", 0) + struct.pack(">i", len(topics))
    for topic in sorted(topics):
        out += _string(topic)
    return out + _bytes(b"")


def decode_consumer_metadata(data: bytes) -> List[str]:
    reader = _Reader(data)
    reader.int16()                              # version
    return [reader.string() for _ in range(reader.int32())]


def encode_member_assignment(assignment: Dict[str, List[int]]) -> bytes:
    """ConsumerProtocolAssignment v0: topic → partitions."""
    out = struct.pack(">h", 0) + struct.pack(">i", len(assignment))
    for topic in sorted(assignment):
        out += _string(topic) + struct.pack(">i", len(assignment[topic]))
        for partition in sorted(assignment[topic]):
            out += struct.pack(">i", partition)
    return out + _bytes(b"")


def decode_member_assignment(data: bytes) -> Dict[str, List[int]]:
    if not data:
        return {}
    reader = _Reader(data)
    reader.int16()                              # version
    out: Dict[str, List[int]] = {}
    for _ in range(reader.int32()):
        topic = reader.string()
        out[topic] = [reader.int32() for _ in range(reader.int32())]
    return out


def range_assign(members: Dict[str, List[str]],
                 partitions_by_topic: Dict[str, List[int]]
                 ) -> Dict[str, Dict[str, List[int]]]:
    """Range assignment (Kafka's default): per topic, split the sorted
    partition list into contiguous ranges over the topic's subscribers in
    member-id order; the first ``extra`` members get one more partition.
    Deterministic, so every member computing it agrees."""
    out: Dict[str, Dict[str, List[int]]] = {m: {} for m in members}
    for topic, partitions in partitions_by_topic.items():
        subscribers = sorted(m for m, topics in members.items()
                             if topic in topics)
        if not subscribers:
            continue
        parts = sorted(partitions)
        base, extra = divmod(len(parts), len(subscribers))
        start = 0
        for index, member in enumerate(subscribers):
            take = base + (1 if index < extra else 0)
            if take:
                out[member][topic] = parts[start:start + take]
            start += take
    return out


class _Broker:
    """One TCP connection + request/response correlation."""

    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 10.0):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout = timeout
        self.correlation = 0
        self.lock = threading.Lock()
        self.sock = None
        self.closed = False
        self._connect()

    def _connect(self) -> None:
        if self.closed:
            raise KafkaError("broker handle is closed")
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.timeout)
        self.sock = sock
        if self.closed:   # close() raced the reconnect: don't leak it
            sock.close()
            raise KafkaError("broker handle is closed")

    def call(self, api_key: int, api_version: int, body: bytes) -> _Reader:
        # One reconnect-and-reissue on transport failure (dead socket —
        # broker restart), the same treatment as the Redis wire client.
        # Standard Kafka at-least-once semantics: a retried Produce whose
        # first attempt partially landed may duplicate, never lose.
        with self.lock:
            try:
                response = self._exchange(api_key, api_version, body)
            except OSError:
                self._connect()     # refuses after close(): no leaks
                response = self._exchange(api_key, api_version, body)
            expected = self.correlation
        reader = _Reader(response)
        correlation = reader.int32()
        if correlation != expected:
            raise KafkaError("correlation id mismatch")
        return reader

    def _exchange(self, api_key: int, api_version: int,
                  body: bytes) -> bytes:
        self.correlation += 1
        header = (struct.pack(">hhi", api_key, api_version,
                              self.correlation)
                  + _string(self.client_id))
        payload = header + body
        self.sock.sendall(struct.pack(">i", len(payload)) + payload)
        size = struct.unpack(">i", self._read(4))[0]
        return self._read(size)

    def _read(self, n: int) -> bytes:
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                raise ConnectionError("broker connection closed")
            data += chunk
        return data

    def close(self):
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass


class _PartitionFetcher(threading.Thread):
    """One fetch loop per assigned partition over its OWN broker
    connection (parity: kafka-go gives every reader its own dialer,
    kafka.go:181-186): a slow partition leader — or an empty partition
    long-polling at the broker — no longer head-of-line blocks its
    siblings, and heartbeats move to the coordinator loop instead of
    interleaving with fetch latency. Errors are recorded on ``.error``
    and end the thread; the owning poller notices and restarts the
    assignment pass."""

    def __init__(self, client: "KafkaClient", topic: str, partition: int,
                 resolve_offset, q: "queue.Queue", make_committer,
                 stop: threading.Event):
        super().__init__(daemon=True, name=f"kafka-{topic}[{partition}]")
        self.client = client
        self.topic = topic
        self.partition = partition
        # resolved lazily INSIDE this thread (committed-or-earliest): an
        # unreachable leader during offset lookup must stall only this
        # partition, not the poller's whole assignment pass
        self.resolve_offset = resolve_offset
        self.offset: Optional[int] = None
        self.q = q
        self.make_committer = make_committer
        self.stop_event = stop
        self.error: Optional[BaseException] = None

    def _stopping(self) -> bool:
        return self.stop_event.is_set() or self.client._closed

    def _paused(self) -> bool:
        return self.client.is_paused(self.topic)

    def _sleep(self, seconds: float) -> None:
        """Interruptible sleep: long connection backoffs must still honor
        stop() promptly (_stop_fetchers joins with a 5 s timeout)."""
        deadline = time.monotonic() + seconds
        while not self._stopping():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(0.1, remaining))

    def run(self) -> None:
        client = self.client
        conn: Optional[_Broker] = None
        offset_failures = 0
        conn_backoff = 0.5
        try:
            while not self._stopping():
                if self._paused():
                    # backpressure pause (client.pause(topic)): stop
                    # issuing fetches — the connection stays up, offsets
                    # stay put, and resume is just the flag clearing
                    self._sleep(0.1)
                    continue
                started = time.monotonic()
                try:
                    if conn is None:
                        host, port = client._leader_addr(self.topic,
                                                         self.partition)
                        conn = _Broker(host, port, client.client_id)
                    if self.offset is None:
                        try:
                            self.offset = self.resolve_offset(
                                self.partition)
                            offset_failures = 0
                        except KafkaError:
                            # coordinator loading / moved leadership
                            # during offset lookup is usually transient
                            # and partition-local: retry here a few times
                            # instead of tearing down every sibling — but
                            # a PERSISTENT failure (desynced shared
                            # handle, authz error) must escalate to the
                            # poller, whose full rejoin refreshes the
                            # coordinator connection this loop never
                            # could
                            offset_failures += 1
                            if offset_failures >= 6:
                                raise
                            client.logger.warn(
                                "kafka %s[%d]: offset resolution failed "
                                "(%d/6), retrying", self.topic,
                                self.partition, offset_failures)
                            time.sleep(0.5)
                            continue
                    batch = client._fetch(self.topic, self.partition,
                                          self.offset, broker=conn)
                except KafkaOffsetOutOfRange:
                    # retention expired past our offset: reset to earliest
                    try:
                        self.offset = client._earliest_offset(
                            self.topic, self.partition)
                        offset_failures = 0
                    except (OSError, ConnectionError, KafkaError):
                        offset_failures += 1
                        if offset_failures >= 6:
                            raise
                        client.logger.warn(
                            "kafka %s[%d]: earliest-offset reset failed "
                            "(%d/6), retrying", self.topic,
                            self.partition, offset_failures)
                        time.sleep(0.5)
                    continue
                except (OSError, ConnectionError):
                    # leader down/moved or dead conn: heal in-place on a
                    # fresh socket — dying here would tear down every
                    # sibling fetcher for one partition's outage. The
                    # metadata refresh is equally non-fatal: bootstrap
                    # being down too (whole-cluster restart) just means
                    # retry next pass. Backoff doubles toward 10 s so a
                    # long outage isn't a half-second reconnect hammer,
                    # and the refresh is throttled topic-wide (every
                    # sibling fetcher hits this path at once).
                    if conn is not None:
                        conn.close()
                        conn = None
                    try:
                        client._refresh_metadata_throttled(self.topic)
                    except (OSError, ConnectionError, KafkaError):
                        pass
                    self._sleep(conn_backoff)
                    conn_backoff = min(conn_backoff * 2, 10.0)
                    continue
                conn_backoff = 0.5   # successful fetch: connection healthy
                for offset, key, value in batch:
                    self.offset = offset + 1
                    # unwrap the opt-in trace envelope (base.py): the
                    # publisher's traceparent surfaces as a message
                    # header, exactly like inmem's native headers
                    traceparent, value = decode_trace_envelope(value)
                    metadata: Dict[str, Any] = {"partition": self.partition,
                                                "offset": offset}
                    if traceparent is not None:
                        metadata["traceparent"] = traceparent
                    message = Message(
                        self.topic, value, key,
                        metadata=metadata,
                        committer=self.make_committer(self.partition,
                                                      offset + 1))
                    while not self._stopping():
                        try:
                            self.q.put(message, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                if not batch:
                    # a broker honouring fetch_max_wait_ms already parked
                    # us server-side; only top up if it returned early,
                    # so an empty partition never busy-spins
                    remaining = client.fetch_max_wait_ms / 1000.0 \
                        - (time.monotonic() - started)
                    if remaining > 0:
                        time.sleep(min(remaining, 0.5))
        except BaseException as exc:  # noqa: BLE001 — reported to poller
            self.error = exc
        finally:
            if conn is not None:
                conn.close()


class KafkaClient(PubSub):
    def __init__(self, config, logger, metrics, tracer=None):
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        broker = config.get_or_default("PUBSUB_BROKER",
                                       config.get_or_default("KAFKA_BROKER",
                                                             "localhost:9092"))
        host, _, port = broker.partition(":")
        self.bootstrap = (host, int(port or 9092))
        self.group = config.get_or_default("CONSUMER_ID", "gofr-tpu")
        self.client_id = config.get_or_default("APP_NAME", "gofr-tpu-app")
        self.fetch_max_wait_ms = config.get_int("KAFKA_FETCH_MAX_WAIT_MS", 250)
        # "group": broker-coordinated membership + range assignment
        # (kafka.go:167-220 semantics). "static": every consumer fetches
        # all partitions (brokers without group support).
        self.group_mode = config.get_or_default("KAFKA_GROUP_MODE",
                                                "group").lower()
        self.session_timeout_ms = config.get_int(
            "KAFKA_SESSION_TIMEOUT_MS", 10000)
        self.heartbeat_interval_ms = config.get_int(
            "KAFKA_HEARTBEAT_INTERVAL_MS", 3000)
        # how often pollers re-learn leadership + partition counts;
        # tests shrink it to exercise partition growth quickly
        self.metadata_refresh_s = config.get_float(
            "KAFKA_METADATA_REFRESH_S", 30.0)
        self._memberships: Dict[str, Tuple[Any, str, int]] = {}
        self._group_conns: Dict[str, "_Broker"] = {}
        self._brokers: Dict[Tuple[str, int], _Broker] = {}
        self._meta_lock = threading.Lock()
        self._leaders: Dict[Tuple[str, int], Tuple[str, int]] = {}
        self._meta_refreshed_at: Dict[str, float] = {}
        self._queues: Dict[str, "queue.Queue[Optional[Message]]"] = {}
        self._pollers: Dict[str, threading.Thread] = {}
        # per-topic backpressure flags checked by every partition fetcher
        # (pause()/resume() below) — set means "stop issuing fetches"
        self._pause_events: Dict[str, threading.Event] = {}
        self._closed = False
        self._broker(self.bootstrap)  # fail fast if unreachable
        logger.info("kafka connected %s:%d group=%s", *self.bootstrap,
                    self.group)

    def _broker(self, addr: Tuple[str, int]) -> _Broker:
        # N per-partition fetchers + the event loop's committers race this
        # cache; a bare check-then-insert would leak the loser's socket.
        # Connect OUTSIDE the lock (it can block up to the 10 s timeout),
        # publish under it, close the losing duplicate.
        broker = self._brokers.get(addr)
        if broker is not None:
            return broker
        candidate = _Broker(addr[0], addr[1], self.client_id)
        with self._meta_lock:
            broker = self._brokers.setdefault(addr, candidate)
        if broker is not candidate:
            candidate.close()
        return broker

    # -- metadata / leader routing -----------------------------------------
    def _refresh_metadata(self, topic: str) -> List[int]:
        reader = self._broker(self.bootstrap).call(
            API_METADATA, 1, struct.pack(">i", 1) + _string(topic))
        nodes: Dict[int, Tuple[str, int]] = {}
        for _ in range(reader.int32()):          # brokers
            node_id = reader.int32()
            host = reader.string()
            port = reader.int32()
            reader.string()                      # rack
            nodes[node_id] = (host, port)
        reader.int32()                           # controller id
        partitions: List[int] = []
        for _ in range(reader.int32()):          # topics
            reader.int16()                       # topic error
            name = reader.string()
            reader.int8()                        # is_internal
            for _ in range(reader.int32()):
                reader.int16()                   # partition error
                partition = reader.int32()
                leader = reader.int32()
                for _ in range(reader.int32()):  # replicas
                    reader.int32()
                for _ in range(reader.int32()):  # isr
                    reader.int32()
                if name == topic:
                    partitions.append(partition)
                    if leader in nodes:
                        with self._meta_lock:
                            self._leaders[(topic, partition)] = nodes[leader]
        with self._meta_lock:
            self._meta_refreshed_at[topic] = time.monotonic()
        return sorted(partitions)

    def _refresh_metadata_throttled(self, topic: str,
                                    min_interval: float = 1.0) -> None:
        """Topic-wide refresh rate limit. When a broker dies, every one of
        the topic's partition fetchers hits its reconnect path at once and
        each would issue an identical Metadata request per backoff tick —
        a refresh stampede against the (possibly still recovering)
        bootstrap broker. Only one fetcher per interval refreshes; the
        rest reuse its result from the shared leader cache."""
        with self._meta_lock:
            last = self._meta_refreshed_at.get(topic)
            if last is not None \
                    and time.monotonic() - last < min_interval:
                return
            # claim the interval before the slow lock-free refresh so
            # racing fetchers skip instead of queueing up behind it
            self._meta_refreshed_at[topic] = time.monotonic()
        self._refresh_metadata(topic)

    def _leader_addr(self, topic: str, partition: int) -> Tuple[str, int]:
        addr = self._leaders.get((topic, partition))
        if addr is None:
            self._refresh_metadata(topic)
            addr = self._leaders.get((topic, partition), self.bootstrap)
        return addr

    def _leader(self, topic: str, partition: int) -> _Broker:
        return self._broker(self._leader_addr(topic, partition))

    # -- produce ------------------------------------------------------------
    def publish(self, topic: str, payload: bytes, key: bytes = b"") -> None:
        self.metrics.increment_counter("app_pubsub_publish_total_count",
                                       topic=topic)
        # cross-service trace propagation: message-set v1 has no record
        # headers, so when a trace is in flight the traceparent rides in
        # the opt-in byte envelope (base.py). Publishes outside a span
        # keep the raw wire payload byte-for-byte unchanged.
        span = None
        if self.tracer is not None:
            from gofr_tpu_torch.trace import current_span, format_traceparent
            if current_span() is not None:
                span = self.tracer.start_span("pubsub.publish")
                span.set_attribute("topic", topic)
                span.set_attribute("backend", "KAFKA")
                payload = encode_trace_envelope(format_traceparent(span),
                                                payload)
        try:
            self._publish_raw(topic, payload, key)
        except Exception:
            if span is not None:
                span.set_status("ERROR")
            raise
        finally:
            if span is not None:
                span.finish()

    def _publish_raw(self, topic: str, payload: bytes,
                     key: bytes = b"") -> None:
        partitions = self._refresh_metadata(topic) or [0]
        partition = (zlib.crc32(key) % len(partitions)) if key \
            else int(time.time() * 1e6) % len(partitions)
        message_set = encode_message_set([(key, payload)])
        body = (struct.pack(">hi", 1, 10000)          # acks=1, timeout
                + struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 1) + struct.pack(">i", partition)
                + _bytes(message_set))
        reader = self._leader(topic, partition).call(API_PRODUCE, 2, body)
        for _ in range(reader.int32()):
            reader.string()                           # topic
            for _ in range(reader.int32()):
                reader.int32()                        # partition
                error = reader.int16()
                reader.int64()                        # base offset
                reader.int64()                        # log append time
                if error:
                    raise KafkaError(f"produce error code {error}")
        self.metrics.increment_counter("app_pubsub_publish_success_count",
                                       topic=topic)

    # -- offsets ------------------------------------------------------------
    def _committed_offset(self, topic: str, partition: int,
                          broker: Optional["_Broker"] = None) -> int:
        """OffsetFetch v1. Group offsets live on the coordinator, so group
        mode must read them there — on a multi-broker cluster asking the
        bootstrap node returns NOT_COORDINATOR, and silently treating
        that as "no commit" would reset the partition to earliest."""
        body = (_string(self.group) + struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 1) + struct.pack(">i", partition))
        reader = (broker or self._broker(self.bootstrap)).call(
            API_OFFSET_FETCH, 1, body)
        for _ in range(reader.int32()):
            reader.string()
            for _ in range(reader.int32()):
                reader.int32()
                offset = reader.int64()
                reader.string()                       # metadata
                error = reader.int16()
                if error:
                    raise KafkaError(f"offset fetch error {error}")
                return max(0, offset)
        return 0

    def _earliest_offset(self, topic: str, partition: int) -> int:
        body = (struct.pack(">i", -1) + struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iq", partition, -2))   # -2 = earliest
        reader = self._leader(topic, partition).call(API_LIST_OFFSETS, 1,
                                                     body)
        for _ in range(reader.int32()):
            reader.string()
            for _ in range(reader.int32()):
                reader.int32()
                error = reader.int16()
                reader.int64()                        # timestamp
                offset = reader.int64()
                if error:
                    raise KafkaError(f"list offsets error {error}")
                return offset
        return 0

    def _commit_offset(self, topic: str, partition: int, offset: int,
                       generation: int = -1, member_id: str = "",
                       broker: Optional["_Broker"] = None) -> None:
        """OffsetCommit v2. In group mode the commit carries the member's
        generation so a fenced (rebalanced-away) member cannot clobber the
        new owner's progress."""
        body = (_string(self.group) + struct.pack(">i", generation)
                + _string(member_id)
                + struct.pack(">q", -1)
                + struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iq", partition, offset) + _string(None))
        reader = (broker or self._coordinator_broker()).call(
            API_OFFSET_COMMIT, 2, body)
        for _ in range(reader.int32()):
            reader.string()
            for _ in range(reader.int32()):
                reader.int32()
                error = reader.int16()
                if error in (ERR_ILLEGAL_GENERATION, ERR_UNKNOWN_MEMBER,
                             ERR_REBALANCE_IN_PROGRESS):
                    raise KafkaRebalance(f"offset commit fenced ({error})")
                if error:
                    self.logger.error("kafka offset commit error %d", error)

    # -- group coordination (kafka.go:167-220 scale-out semantics) ----------
    def _coordinator_broker(self) -> _Broker:
        addr = getattr(self, "_coordinator_addr", None)
        return self._broker(addr or self.bootstrap)

    def _find_coordinator_addr(self) -> Tuple[str, int]:
        reader = self._broker(self.bootstrap).call(
            API_FIND_COORDINATOR, 0, _string(self.group))
        error = reader.int16()
        if error:
            raise KafkaError(f"find coordinator error {error}")
        reader.int32()                            # node id
        host = reader.string()
        port = reader.int32()
        self._coordinator_addr = (host, port)
        return (host, port)

    def _group_conn(self, topic: str, addr: Tuple[str, int]) -> _Broker:
        """Dedicated coordinator connection per topic membership. A
        JoinGroup BLOCKS server-side until the rebalance barrier
        completes; on a shared connection that would stall every other
        request from this client (heartbeats of other memberships,
        commits), so group traffic never rides the shared broker cache."""
        conn = self._group_conns.get(topic)
        if conn is None or (conn.host, conn.port) != addr or conn.closed:
            if conn is not None:
                conn.close()
            # a JoinGroup response can be held server-side for the whole
            # rebalance window (dead members time out of their session),
            # so this socket's timeout must comfortably exceed it
            conn = _Broker(addr[0], addr[1], self.client_id,
                           timeout=max(30.0,
                                       self.session_timeout_ms / 1000 * 3))
            self._group_conns[topic] = conn
        return conn

    def _join_group(self, coordinator: _Broker, topic: str,
                    member_id: str):
        """JoinGroup v0 → (generation, member_id, is_leader, members
        metadata map — non-empty only for the leader)."""
        metadata = encode_consumer_metadata([topic])
        body = (_string(self.group)
                + struct.pack(">i", self.session_timeout_ms)
                + _string(member_id) + _string("consumer")
                + struct.pack(">i", 1) + _string("range") + _bytes(metadata))
        reader = coordinator.call(API_JOIN_GROUP, 0, body)
        error = reader.int16()
        if error == ERR_UNKNOWN_MEMBER:
            raise KafkaRebalance("join: unknown member id",
                                 reset_member=True)
        if error:
            raise KafkaError(f"join group error {error}")
        generation = reader.int32()
        reader.string()                           # protocol ("range")
        leader_id = reader.string()
        my_id = reader.string()
        members: Dict[str, List[str]] = {}
        for _ in range(reader.int32()):
            mid = reader.string()
            meta = reader.raw_bytes() or b""
            members[mid] = decode_consumer_metadata(meta)
        return generation, my_id, my_id == leader_id, members

    def _sync_group(self, coordinator: _Broker, generation: int,
                    member_id: str,
                    assignments: Optional[Dict[str, Dict[str, List[int]]]]
                    ) -> Dict[str, List[int]]:
        """SyncGroup v0. The leader ships every member's assignment; the
        coordinator hands each member its own back."""
        entries = assignments or {}
        body = (_string(self.group) + struct.pack(">i", generation)
                + _string(member_id) + struct.pack(">i", len(entries)))
        for mid in sorted(entries):
            body += _string(mid) + _bytes(
                encode_member_assignment(entries[mid]))
        reader = coordinator.call(API_SYNC_GROUP, 0, body)
        error = reader.int16()
        if error in (ERR_UNKNOWN_MEMBER, ERR_ILLEGAL_GENERATION,
                     ERR_REBALANCE_IN_PROGRESS):
            raise KafkaRebalance(f"sync: rebalance ({error})",
                                 reset_member=error == ERR_UNKNOWN_MEMBER)
        if error:
            raise KafkaError(f"sync group error {error}")
        return decode_member_assignment(reader.raw_bytes() or b"")

    def _heartbeat(self, coordinator: _Broker, generation: int,
                   member_id: str) -> None:
        body = (_string(self.group) + struct.pack(">i", generation)
                + _string(member_id))
        reader = coordinator.call(API_HEARTBEAT, 0, body)
        error = reader.int16()
        if error in (ERR_UNKNOWN_MEMBER, ERR_ILLEGAL_GENERATION,
                     ERR_REBALANCE_IN_PROGRESS):
            raise KafkaRebalance(f"heartbeat: rebalance ({error})",
                                 reset_member=error == ERR_UNKNOWN_MEMBER)
        if error:
            raise KafkaError(f"heartbeat error {error}")

    def _leave_group(self, member_id: str,
                     broker: Optional[_Broker] = None) -> None:
        try:
            body = _string(self.group) + _string(member_id)
            (broker or self._coordinator_broker()).call(
                API_LEAVE_GROUP, 0, body)
        except Exception:  # noqa: BLE001 — best effort on shutdown; the
            pass           # session timeout evicts us anyway

    def _rejoin(self, topic: str, member_id: str):
        """One find-coordinator → join → (leader assigns) → sync cycle.
        Returns (coordinator, generation, member_id, my partitions)."""
        # refresh before joining: every member (not just the elected
        # leader) re-learns partition leadership here, so a moved leader
        # or stale cache heals on the rebalance path
        self._refresh_metadata(topic)
        addr = self._find_coordinator_addr()
        coordinator = self._group_conn(topic, addr)
        generation, member_id, is_leader, members = self._join_group(
            coordinator, topic, member_id)
        assignments = None
        if is_leader:
            all_topics = sorted({t for topics in members.values()
                                 for t in topics})
            partitions_by_topic = {
                t: self._refresh_metadata(t) for t in all_topics}
            assignments = range_assign(members, partitions_by_topic)
        my_assignment = self._sync_group(coordinator, generation, member_id,
                                         assignments)
        self._memberships[topic] = (coordinator, member_id, generation)
        return coordinator, generation, member_id, \
            sorted(my_assignment.get(topic, []))

    # -- fetch loop (per-topic reader, kafka.go:181-186) --------------------
    def _poll_topic(self, topic: str) -> None:
        if self.group_mode == "static":
            self._poll_topic_static(topic)
        else:
            self._poll_topic_group(topic)

    def _spawn_fetchers(self, topic: str, partitions: List[int],
                        resolve_offset, make_committer,
                        stop: "threading.Event"
                        ) -> Dict[int, "_PartitionFetcher"]:
        fetchers = {
            partition: _PartitionFetcher(self, topic, partition,
                                         resolve_offset,
                                         self._queues[topic],
                                         make_committer, stop)
            for partition in partitions}
        for fetcher in fetchers.values():
            fetcher.start()
        return fetchers

    @staticmethod
    def _check_fetchers(fetchers: Dict[int, "_PartitionFetcher"]) -> None:
        for fetcher in fetchers.values():
            if not fetcher.is_alive():
                raise fetcher.error or KafkaError(
                    f"fetcher for partition {fetcher.partition} died")

    @staticmethod
    def _stop_fetchers(fetchers: Dict[int, "_PartitionFetcher"],
                       stop: "threading.Event") -> None:
        stop.set()
        for fetcher in fetchers.values():
            fetcher.join(timeout=5.0)

    def _poll_topic_group(self, topic: str) -> None:
        """Group-coordinated fetch loop: join the consumer group, fetch
        only the partitions the leader assigned to this member, heartbeat,
        and rejoin on any membership change (kafka.go:167-220, 234-242:
        two instances in one group split partitions; a dead member's
        partitions are reclaimed by survivors after its session times
        out)."""
        q = self._queues[topic]
        backoff = 0.1
        heartbeat_s = self.heartbeat_interval_ms / 1000.0
        member_id = ""
        while not self._closed:
            try:
                (coordinator, generation, member_id,
                 partitions) = self._rejoin(topic, member_id)
                self.logger.info(
                    "kafka group %s member %s gen %d: assigned %s%r",
                    self.group, member_id, generation, topic, partitions)
                # one fetcher thread + dedicated connection per assigned
                # partition (kafka.go:181-186: kafka-go reader-per-
                # partition concurrency): a slow partition leader or an
                # empty long-polling partition can't head-of-line block
                # its siblings, and each fetcher resolves its own
                # committed-or-earliest start offset so a dead leader
                # stalls only its partition. Group offsets live on the
                # coordinator (shared broker cache — its calls are
                # locked, and commits must NOT ride the group conn: a
                # rebalance blocks that conn server-side for seconds
                # while commit() runs on the app's event loop).
                def resolve_offset(partition):
                    committed = self._committed_offset(
                        topic, partition, self._coordinator_broker())
                    return committed or self._earliest_offset(topic,
                                                              partition)

                def make_committer(partition, next_offset):
                    return self._make_committer(topic, partition,
                                                next_offset, generation,
                                                member_id)

                stop = threading.Event()
                fetchers = self._spawn_fetchers(topic, partitions,
                                                resolve_offset,
                                                make_committer, stop)
                known_partition_count = len(self._refresh_metadata(topic))
                refresh_at = time.monotonic() + self.metadata_refresh_s
                try:
                    # the poller thread is now the pure coordinator loop:
                    # heartbeat on schedule (no longer entangled with
                    # fetch latency or a slow consumer's queue drain),
                    # watch fetcher health, detect partition growth
                    while not self._closed:
                        self._heartbeat(coordinator, generation, member_id)
                        deadline = time.monotonic() + heartbeat_s
                        while time.monotonic() < deadline \
                                and not self._closed:
                            self._check_fetchers(fetchers)
                            time.sleep(0.05)
                        backoff = 0.1
                        if time.monotonic() >= refresh_at:
                            # re-learn leadership (moves heal without an
                            # error) and detect partition growth, which
                            # the group must rebalance over (the
                            # coordinator won't tell us)
                            current = len(self._refresh_metadata(topic))
                            refresh_at = time.monotonic() + self.metadata_refresh_s
                            if current != known_partition_count:
                                raise KafkaRebalance(
                                    f"partition count changed "
                                    f"{known_partition_count} -> {current}")
                finally:
                    self._stop_fetchers(fetchers, stop)
            except KafkaRebalance as exc:
                if self._closed:
                    break
                if getattr(exc, "reset_member", False):
                    member_id = ""
                self.logger.info("kafka %s rebalancing: %s", topic, exc)
                continue          # rejoin promptly, no backoff
            except Exception as exc:
                if self._closed:
                    break
                self.logger.error(
                    "kafka group poller %s errored (retrying in %.1fs): %r",
                    topic, backoff, exc)
                time.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
        membership = self._memberships.pop(topic, None)
        if membership is not None:
            self._leave_group(membership[1], membership[0])
        q.put(None)

    def _poll_topic_static(self, topic: str) -> None:
        """Static fetch loop (every partition, no group coordination).
        Survives broker outages: an errored pass (fetch/metadata failure
        beyond call()'s one immediate reconnect) backs off and retries
        from the committed offset instead of dying — otherwise the first
        multi-second restart would permanently kill the subscription
        while publish happily recovers."""
        q = self._queues[topic]
        backoff = 0.1
        while not self._closed:
            try:
                partitions = self._refresh_metadata(topic)
                if not partitions:
                    # topic doesn't exist yet (or metadata stale): retry
                    # via the backoff path instead of idling forever
                    raise KafkaError(f"no partitions for topic {topic!r}")

                def resolve_offset(partition):
                    committed = self._committed_offset(topic, partition)
                    return committed or self._earliest_offset(topic,
                                                              partition)

                def make_committer(partition, next_offset):
                    return self._make_committer(topic, partition,
                                                next_offset)

                # per-partition fetcher threads (see _PartitionFetcher):
                # this loop just watches health and partition growth
                stop = threading.Event()
                fetchers = self._spawn_fetchers(topic, partitions,
                                                resolve_offset,
                                                make_committer, stop)
                refresh_at = time.monotonic() + self.metadata_refresh_s
                healthy_at = time.monotonic() + 2.0
                try:
                    while not self._closed:
                        self._check_fetchers(fetchers)
                        if time.monotonic() >= healthy_at:
                            # only a *sustained* healthy pass resets the
                            # backoff — fetchers dying right after spawn
                            # (non-retryable fetch error) must keep
                            # escalating toward the 10 s cap, not hot-loop
                            backoff = 0.1
                        if time.monotonic() >= refresh_at:
                            # periodically re-learn partitions (growth
                            # after subscribe) without waiting for error
                            refresh_at = time.monotonic() \
                                + self.metadata_refresh_s
                            for partition in self._refresh_metadata(topic):
                                if partition not in fetchers:
                                    fetcher = _PartitionFetcher(
                                        self, topic, partition,
                                        resolve_offset, q,
                                        make_committer, stop)
                                    fetcher.start()
                                    fetchers[partition] = fetcher
                        time.sleep(0.05)
                finally:
                    self._stop_fetchers(fetchers, stop)
            except Exception as exc:
                if self._closed:
                    break
                self.logger.error(
                    "kafka poller %s errored (retrying in %.1fs): %r",
                    topic, backoff, exc)
                time.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
        q.put(None)

    def _make_committer(self, topic, partition, next_offset,
                        generation: int = -1, member_id: str = "",
                        broker: Optional["_Broker"] = None):
        return lambda: self._commit_offset(topic, partition, next_offset,
                                           generation, member_id, broker)

    def _fetch(self, topic: str, partition: int, offset: int,
               broker: Optional[_Broker] = None
               ) -> List[Tuple[int, bytes, bytes]]:
        body = (struct.pack(">iii", -1, self.fetch_max_wait_ms, 1)
                + struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 1)
                + struct.pack(">iqi", partition, offset, 4 * 1024 * 1024))
        conn = broker if broker is not None \
            else self._leader(topic, partition)
        reader = conn.call(API_FETCH, 2, body)
        reader.int32()                                # throttle time
        out: List[Tuple[int, bytes, bytes]] = []
        for _ in range(reader.int32()):
            reader.string()
            for _ in range(reader.int32()):
                reader.int32()                        # partition
                error = reader.int16()
                reader.int64()                        # high watermark
                message_set = reader.raw_bytes() or b""
                if error == 1:
                    raise KafkaOffsetOutOfRange(
                        f"offset {offset} out of range for "
                        f"{topic}/{partition}")
                if error:
                    raise KafkaError(f"fetch error code {error}")
                out.extend(decode_message_set(message_set, offset))
        return out

    # -- backpressure -----------------------------------------------------
    def pause(self, topic: str, reason: str = "backpressure") -> None:
        """Stop this topic's partition fetchers from issuing fetches —
        connections stay up, offsets stay put, the consumer group keeps
        heartbeating (no rebalance). Idempotent; only the unpaused→paused
        transition is counted in
        ``app_pubsub_consumer_paused_total{topic,reason}``."""
        with self._meta_lock:
            event = self._pause_events.setdefault(topic, threading.Event())
        if not event.is_set():
            event.set()
            if self.metrics is not None:
                self.metrics.increment_counter(
                    "app_pubsub_consumer_paused_total",
                    topic=topic, reason=reason)
            self.logger.info("kafka %s: consumer paused (%s)", topic,
                             reason)

    def resume(self, topic: str) -> None:
        """Clear a ``pause`` — fetchers pick up from their held offsets
        on their next loop pass. Idempotent."""
        event = self._pause_events.get(topic)
        if event is not None and event.is_set():
            event.clear()
            self.logger.info("kafka %s: consumer resumed", topic)

    def is_paused(self, topic: str) -> bool:
        event = self._pause_events.get(topic)
        return event is not None and event.is_set()

    async def subscribe(self, topic: str) -> Optional[Message]:
        import asyncio
        self.metrics.increment_counter("app_pubsub_subscribe_total_count",
                                       topic=topic)
        if topic not in self._pollers:
            self._queues[topic] = queue.Queue(maxsize=65536)
            poller = threading.Thread(target=self._poll_topic, args=(topic,),
                                      daemon=True, name=f"kafka-{topic}")
            self._pollers[topic] = poller
            poller.start()
        message = await asyncio.get_running_loop().run_in_executor(
            None, self._queues[topic].get)
        if message is not None:
            self.metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=topic)
        return message

    # -- topic admin (kafka.go:247-264) -------------------------------------
    def create_topic(self, topic: str, partitions: int = 1,
                     replication: int = 1) -> None:
        body = (struct.pack(">i", 1) + _string(topic)
                + struct.pack(">ih", partitions, replication)
                + struct.pack(">i", 0)                # assignments
                + struct.pack(">i", 0)                # configs
                + struct.pack(">i", 10000))           # timeout
        reader = self._broker(self.bootstrap).call(API_CREATE_TOPICS, 0, body)
        for _ in range(reader.int32()):
            reader.string()
            error = reader.int16()
            if error and error != 36:                 # 36 = already exists
                raise KafkaError(f"create topic error {error}")

    def delete_topic(self, topic: str) -> None:
        body = (struct.pack(">i", 1) + _string(topic)
                + struct.pack(">i", 10000))
        reader = self._broker(self.bootstrap).call(API_DELETE_TOPICS, 0, body)
        for _ in range(reader.int32()):
            reader.string()
            error = reader.int16()
            if error and error != 3:                  # 3 = unknown topic
                raise KafkaError(f"delete topic error {error}")

    def health_check(self) -> dict:
        try:
            self._broker(self.bootstrap).call(
                API_METADATA, 1, struct.pack(">i", 0))
            return {"status": "UP",
                    "details": {"backend": "KAFKA",
                                "broker": f"{self.bootstrap[0]}:"
                                          f"{self.bootstrap[1]}",
                                "group": self.group}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def close(self) -> None:
        self._closed = True
        # leave the group eagerly so the coordinator rebalances survivors
        # now rather than after the session timeout
        for conn, member_id, _ in list(self._memberships.values()):
            self._leave_group(member_id, conn)
        self._memberships.clear()
        for q in self._queues.values():
            q.put(None)
        for conn in list(self._group_conns.values()):
            conn.close()
        for broker in list(self._brokers.values()):
            broker.close()
