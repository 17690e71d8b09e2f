"""In-process test servers for ``chip_smoke.py``'s datasource phase, on
the stdlib's sockets and threads and the port's own codec:

- :class:`KafkaLog`: a single-node Kafka log with a group coordinator
  (Metadata v1, Produce v2, Fetch v2 with a server-side long poll,
  ListOffsets v1, OffsetFetch v1, OffsetCommit v2 fenced by generation,
  FindCoordinator, JoinGroup, SyncGroup, Heartbeat and LeaveGroup v0);
- :class:`MQTTBroker`: an MQTT 3.1.1 broker (CONNECT, SUBSCRIBE,
  PUBLISH at QoS 0 and 1 routed by topic, PINGREQ, DISCONNECT);
- :class:`RESPServer`: a RESP2 server in front of the port's
  ``InMemoryRedis``.

Each listens on 127.0.0.1 at a free port (``.port``), keeps everything
in memory, counts the bytes it reads and writes (``wire_bytes()``) and
stops with ``stop()``. They stand in for real brokers where a host has
none; they are not part of the framework.

Run alone, ``python3 scripts/wire_brokers.py`` starts the three and
prints their ports until interrupted.
"""

from __future__ import annotations

import socket
import struct
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gofr_tpu_torch.datasource.pubsub.kafka import (  # noqa: E402
    _bytes, _Reader, _string, decode_message_set, encode_message_set)

ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER = 25
ERR_REBALANCE_IN_PROGRESS = 27


class _Server:
    """The accept loop, a thread a connection, byte counters, stop."""

    name = "server"

    def __init__(self):
        self.server = socket.socket()
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("127.0.0.1", 0))
        self.server.listen(64)
        self.server.settimeout(0.2)
        self.port = self.server.getsockname()[1]
        self.bytes = 0
        self.running = True
        self._count_lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._start(self._accept_loop, f"{self.name}-accept")

    def _start(self, target, name, *args) -> None:
        thread = threading.Thread(target=target, args=args, name=name,
                                  daemon=True)
        self._threads.append(thread)
        thread.start()

    def _accept_loop(self) -> None:
        while self.running:
            try:
                conn, _ = self.server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._count_lock:
                self._conns.append(conn)
            self._start(self._serve_conn, f"{self.name}-conn", conn)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self.serve(conn)
        except (OSError, ConnectionError, IndexError, struct.error):
            pass
        finally:
            self.closed(conn)
            try:
                conn.close()
            except OSError:
                pass

    def serve(self, conn: socket.socket) -> None:
        raise NotImplementedError

    def closed(self, conn: socket.socket) -> None:
        """A connection ended (its peer left or the server stopped)."""

    def recv_exact(self, conn: socket.socket, n: int) -> Optional[bytes]:
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        self.count(n)
        return data

    def count(self, n: int) -> None:
        with self._count_lock:
            self.bytes += n

    def send(self, conn: socket.socket, data: bytes) -> None:
        conn.sendall(data)
        self.count(len(data))

    def wire_bytes(self) -> int:
        with self._count_lock:
            return self.bytes

    def stop(self) -> None:
        self.running = False
        try:
            self.server.close()
        except OSError:
            pass
        with self._count_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            # a bare close would leave a client blocked in recv waiting
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for thread in self._threads:
            thread.join(timeout=2.0)


# -- Kafka ----------------------------------------------------------------------

class KafkaLog(_Server):
    """One broker (node 0) holding every partition's log in memory, and
    the group coordinator: a join barrier of ``join_window`` seconds,
    generations that fence commits and heartbeats, and eviction of a
    member whose connection dies. ``commits`` lists every accepted
    commit as (group, topic, partition, offset), in order; ``fetches``
    counts the fetches answered."""

    name = "kafka"

    def __init__(self, join_window: float = 1.0):
        self.logs: Dict[Tuple[str, int], List[Tuple[bytes, bytes]]] = {}
        self.offsets: Dict[Tuple[str, str, int], int] = {}
        self.partitions: Dict[str, int] = {}
        self.commits: List[Tuple[str, str, int, int]] = []
        self.fetches = 0
        self.groups: Dict[str, Dict[str, Any]] = {}
        self.gcond = threading.Condition()
        self.data = threading.Condition()
        self.join_window = join_window
        super().__init__()

    def messages(self, topic: str, partition: int = 0) -> List[bytes]:
        with self.data:
            return [value for _, value in self.logs.get((topic, partition),
                                                        [])]

    def serve(self, conn: socket.socket) -> None:
        while self.running:
            raw = self.recv_exact(conn, 4)
            if raw is None:
                return
            payload = self.recv_exact(conn, struct.unpack(">i", raw)[0])
            if payload is None:
                return
            reader = _Reader(payload)
            api_key = reader.int16()
            reader.int16()                      # api version
            correlation = reader.int32()
            reader.string()                     # client id
            body = self.handle(api_key, reader, conn)
            response = struct.pack(">i", correlation) + body
            self.send(conn, struct.pack(">i", len(response)) + response)

    def closed(self, conn: socket.socket) -> None:
        # a dead connection is a dead member: the survivors rebalance
        with self.gcond:
            for group in self.groups.values():
                dead = [m for m, c in group["conns"].items() if c is conn]
                dead += [m for m, c in group["pending_conns"].items()
                         if c is conn]
                for member in dead:
                    for key in ("members", "conns", "pending",
                                "pending_conns"):
                        group[key].pop(member, None)
                if dead and group["members"]:
                    self._start_rebalance(group)

    def _log(self, topic: str, partition: int) -> List[Tuple[bytes, bytes]]:
        return self.logs.setdefault((topic, partition), [])

    def handle(self, api_key: int, reader: _Reader, conn) -> bytes:
        handler = {0: self._produce, 1: self._fetch, 2: self._list_offsets,
                   3: self._metadata, 8: self._offset_commit,
                   9: self._offset_fetch, 10: self._find_coordinator,
                   11: self._join, 12: self._heartbeat, 13: self._leave,
                   14: self._sync}.get(api_key)
        if handler is None:
            raise ConnectionError(f"kafka log: unhandled api {api_key}")
        return handler(reader, conn)

    def _metadata(self, reader, conn) -> bytes:
        topics = [reader.string() for _ in range(reader.int32())]
        with self.data:
            if not topics:
                topics = sorted({t for t, _ in self.logs})
            out = struct.pack(">i", 1)                      # one broker
            out += (struct.pack(">i", 0) + _string("127.0.0.1")
                    + struct.pack(">i", self.port) + _string(None))
            out += struct.pack(">i", 0)                     # controller
            out += struct.pack(">i", len(topics))
            for topic in topics:
                n_parts = self.partitions.setdefault(topic, 1)
                for p in range(n_parts):
                    self._log(topic, p)
                out += struct.pack(">h", 0) + _string(topic) + b"\x00"
                out += struct.pack(">i", n_parts)
                for p in range(n_parts):
                    out += struct.pack(">hii", 0, p, 0)     # err, part, leader
                    out += struct.pack(">ii", 0, 0)         # replicas, isr
        return out

    def _produce(self, reader, conn) -> bytes:
        reader.int16()                                      # acks
        reader.int32()                                      # timeout
        reader.int32()                                      # topics (1)
        topic = reader.string()
        reader.int32()                                      # partitions (1)
        partition = reader.int32()
        message_set = reader.raw_bytes() or b""
        with self.data:
            log = self._log(topic, partition)
            base = len(log)
            for _, key, value in decode_message_set(message_set, 0):
                log.append((key, value))
            self.data.notify_all()
        return (struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
                + struct.pack(">ihqq", partition, 0, base, -1))

    def _fetch(self, reader, conn) -> bytes:
        reader.int32()                                      # replica
        max_wait = reader.int32() / 1000.0
        reader.int32()                                      # min bytes
        reader.int32()                                      # topics (1)
        topic = reader.string()
        reader.int32()                                      # partitions (1)
        partition = reader.int32()
        offset = reader.int64()
        deadline = time.monotonic() + max_wait
        with self.data:
            log = self._log(topic, partition)
            # the long poll: park until data lands or max_wait passes
            while len(log) <= offset and self.running:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self.data.wait(remaining)
            items = log[offset:]
            high = len(log)
            self.fetches += 1
        message_set = b""
        for i, (key, value) in enumerate(items):
            one = encode_message_set([(key, value)])
            message_set += struct.pack(">q", offset + i) + one[8:]
        return (struct.pack(">i", 0)                        # throttle
                + struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
                + struct.pack(">ihq", partition, 0, high)
                + _bytes(message_set))

    def _list_offsets(self, reader, conn) -> bytes:
        reader.int32()                                      # replica
        reader.int32()                                      # topics (1)
        topic = reader.string()
        reader.int32()                                      # partitions (1)
        partition = reader.int32()
        reader.int64()                                      # -2: earliest
        return (struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
                + struct.pack(">ihqq", partition, 0, -1, 0))

    def _offset_fetch(self, reader, conn) -> bytes:
        group = reader.string()
        reader.int32()
        topic = reader.string()
        reader.int32()
        partition = reader.int32()
        offset = self.offsets.get((group, topic, partition), -1)
        return (struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
                + struct.pack(">iq", partition, offset) + _string(None)
                + struct.pack(">h", 0))

    def _offset_commit(self, reader, conn) -> bytes:
        group_name = reader.string()
        generation = reader.int32()
        member_id = reader.string()
        reader.int64()                                      # retention
        reader.int32()
        topic = reader.string()
        reader.int32()
        partition = reader.int32()
        offset = reader.int64()
        error = 0
        with self.gcond:
            if generation != -1:
                group = self.groups.get(group_name)
                if group is None or member_id not in group["members"]:
                    error = ERR_UNKNOWN_MEMBER
                elif generation != group["generation"]:
                    error = ERR_ILLEGAL_GENERATION
            if not error:
                self.offsets[(group_name, topic, partition)] = offset
                self.commits.append((group_name, topic, partition, offset))
        return (struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
                + struct.pack(">ih", partition, error))

    def _find_coordinator(self, reader, conn) -> bytes:
        reader.string()                                     # group
        return (struct.pack(">hi", 0, 0) + _string("127.0.0.1")
                + struct.pack(">i", self.port))

    # -- the group coordinator ---------------------------------------------
    def _group(self, name: str) -> Dict[str, Any]:
        group = self.groups.get(name)
        if group is None:
            group = {"generation": 0, "members": {}, "conns": {},
                     "pending": {}, "pending_conns": {}, "state": "stable",
                     "leader": None, "assignments": {}, "next": 0,
                     "deadline": 0.0}
            self.groups[name] = group
        return group

    def _start_rebalance(self, group: Dict[str, Any]) -> None:
        group["state"] = "joining"
        group["deadline"] = time.monotonic() + self.join_window
        group["assignments"] = {}
        self.gcond.notify_all()

    @staticmethod
    def _join_refused(member_id: str) -> bytes:
        return (struct.pack(">hi", ERR_UNKNOWN_MEMBER, -1) + _string("")
                + _string("") + _string(member_id) + struct.pack(">i", 0))

    def _join(self, reader, conn) -> bytes:
        group_name = reader.string()
        reader.int32()                                      # session timeout
        member_id = reader.string() or ""
        reader.string()                                     # protocol type
        n_protocols = reader.int32()
        reader.string()                                     # "range"
        metadata = reader.raw_bytes() or b""
        for _ in range(n_protocols - 1):
            reader.string()
            reader.raw_bytes()
        with self.gcond:
            group = self._group(group_name)
            if member_id and member_id not in group["members"] \
                    and member_id not in group["pending"]:
                return self._join_refused(member_id)        # rejoin afresh
            if not member_id:
                member_id = f"member-{group['next']}"
                group["next"] += 1
            group["pending"][member_id] = metadata
            group["pending_conns"][member_id] = conn
            if group["state"] != "joining":
                self._start_rebalance(group)
            self.gcond.notify_all()
            # the barrier: every current member rejoins, or the deadline
            # evicts the stragglers
            while (group["state"] == "joining"
                   and not set(group["members"]) <= set(group["pending"])
                   and time.monotonic() < group["deadline"]):
                self.gcond.wait(0.05)
            if group["state"] == "joining":
                group["members"] = dict(group["pending"])
                group["conns"] = dict(group["pending_conns"])
                group["pending"], group["pending_conns"] = {}, {}
                group["generation"] += 1
                group["leader"] = sorted(group["members"])[0]
                group["assignments"] = {}
                group["state"] = "syncing"
                self.gcond.notify_all()
            if member_id not in group["members"]:
                return self._join_refused(member_id)
            out = (struct.pack(">hi", 0, group["generation"])
                   + _string("range") + _string(group["leader"])
                   + _string(member_id))
            if member_id == group["leader"]:
                out += struct.pack(">i", len(group["members"]))
                for mid in sorted(group["members"]):
                    out += _string(mid) + _bytes(group["members"][mid])
            else:
                out += struct.pack(">i", 0)
            return out

    def _sync(self, reader, conn) -> bytes:
        group_name = reader.string()
        generation = reader.int32()
        member_id = reader.string()
        assignments = {}
        for _ in range(reader.int32()):
            mid = reader.string()
            assignments[mid] = reader.raw_bytes() or b""
        with self.gcond:
            group = self._group(group_name)
            if member_id not in group["members"]:
                return struct.pack(">h", ERR_UNKNOWN_MEMBER) + _bytes(b"")
            if generation != group["generation"]:
                return struct.pack(">h", ERR_ILLEGAL_GENERATION) + _bytes(b"")
            if group["state"] == "joining":
                return (struct.pack(">h", ERR_REBALANCE_IN_PROGRESS)
                        + _bytes(b""))
            if assignments:                                 # the leader's
                group["assignments"] = assignments
                group["state"] = "stable"
                self.gcond.notify_all()
            else:                                           # a follower's
                deadline = time.monotonic() + 5.0
                while (not group["assignments"]
                       and group["generation"] == generation
                       and time.monotonic() < deadline):
                    self.gcond.wait(0.05)
                if group["generation"] != generation:
                    return (struct.pack(">h", ERR_ILLEGAL_GENERATION)
                            + _bytes(b""))
                if not group["assignments"]:
                    return (struct.pack(">h", ERR_REBALANCE_IN_PROGRESS)
                            + _bytes(b""))
            return (struct.pack(">h", 0)
                    + _bytes(group["assignments"].get(member_id, b"")))

    def _heartbeat(self, reader, conn) -> bytes:
        group_name = reader.string()
        generation = reader.int32()
        member_id = reader.string()
        with self.gcond:
            group = self.groups.get(group_name)
            if group is None or member_id not in group["members"]:
                return struct.pack(">h", ERR_UNKNOWN_MEMBER)
            if generation != group["generation"]:
                return struct.pack(">h", ERR_ILLEGAL_GENERATION)
            if group["state"] == "joining":
                return struct.pack(">h", ERR_REBALANCE_IN_PROGRESS)
            return struct.pack(">h", 0)

    def _leave(self, reader, conn) -> bytes:
        group_name = reader.string()
        member_id = reader.string()
        with self.gcond:
            group = self.groups.get(group_name)
            if group and member_id in group["members"]:
                group["members"].pop(member_id, None)
                group["conns"].pop(member_id, None)
                if group["members"]:
                    self._start_rebalance(group)
        return struct.pack(">h", 0)


# -- MQTT -----------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        digit, n = n % 128, n // 128
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


class MQTTBroker(_Server):
    """MQTT 3.1.1: a PUBLISH goes to every connection subscribed to its
    topic (no wildcards), at the lower of its QoS and the granted QoS; a
    QoS 1 PUBLISH is acknowledged. No retained messages, no sessions."""

    name = "mqtt"

    def __init__(self):
        self.subscriptions: Dict[socket.socket, Dict[str, int]] = {}
        self._lock = threading.Lock()
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        self._packet_ids: Dict[socket.socket, int] = {}
        super().__init__()

    def subscribers(self, topic: str) -> int:
        with self._lock:
            return sum(topic in topics
                       for topics in self.subscriptions.values())

    def _read_packet(self, conn) -> Tuple[Optional[int], bytes]:
        first = self.recv_exact(conn, 1)
        if first is None:
            return None, b""
        length, multiplier = 0, 1
        while True:
            byte = self.recv_exact(conn, 1)
            if byte is None:
                return None, b""
            length += (byte[0] & 0x7F) * multiplier
            if not byte[0] & 0x80:
                break
            multiplier *= 128
        body = self.recv_exact(conn, length) if length else b""
        if body is None:
            return None, b""
        return first[0], body

    def _send_to(self, conn, data: bytes) -> None:
        with self._lock:
            lock = self._send_locks.setdefault(conn, threading.Lock())
        with lock:
            self.send(conn, data)

    def serve(self, conn) -> None:
        while self.running:
            first, body = self._read_packet(conn)
            if first is None:
                return
            kind = first & 0xF0
            if kind == 0x10:                                # CONNECT
                self._send_to(conn, bytes([0x20, 2, 0, 0]))
            elif kind == 0x80:                              # SUBSCRIBE
                packet_id, offset, granted = body[:2], 2, []
                while offset < len(body):
                    (n,) = struct.unpack_from(">H", body, offset)
                    topic = body[offset + 2:offset + 2 + n].decode()
                    qos = min(body[offset + 2 + n], 1)
                    offset += 3 + n
                    with self._lock:
                        self.subscriptions.setdefault(conn, {})[topic] = qos
                    granted.append(qos)
                self._send_to(conn, bytes([0x90]) + _varint(2 + len(granted))
                              + packet_id + bytes(granted))
            elif kind == 0x30:                              # PUBLISH
                self._publish(conn, first, body)
            elif kind == 0xC0:                              # PINGREQ
                self._send_to(conn, bytes([0xD0, 0]))
            elif kind == 0xE0:                              # DISCONNECT
                return
            # PUBACK from a subscriber needs nothing

    def _publish(self, conn, first: int, body: bytes) -> None:
        qos = (first >> 1) & 0x03
        (n,) = struct.unpack_from(">H", body, 0)
        topic = body[2:2 + n].decode()
        offset = 2 + n
        if qos:
            packet_id = body[offset:offset + 2]
            offset += 2
            self._send_to(conn, bytes([0x40, 2]) + packet_id)   # PUBACK
        payload = body[offset:]
        with self._lock:
            targets = [(c, topics[topic])
                       for c, topics in self.subscriptions.items()
                       if topic in topics]
        for target, granted in targets:
            out_qos = min(qos, granted)
            frame_body = struct.pack(">H", n) + topic.encode()
            if out_qos:
                with self._lock:
                    pid = self._packet_ids.get(target, 0) % 65535 + 1
                    self._packet_ids[target] = pid
                frame_body += struct.pack(">H", pid)
            frame_body += payload
            try:
                self._send_to(target, bytes([0x30 | (out_qos << 1)])
                              + _varint(len(frame_body)) + frame_body)
            except OSError:
                pass

    def closed(self, conn) -> None:
        with self._lock:
            self.subscriptions.pop(conn, None)
            self._send_locks.pop(conn, None)
            self._packet_ids.pop(conn, None)


# -- RESP -----------------------------------------------------------------------

_STATUS_COMMANDS = ("PING", "SET", "SETEX", "SELECT", "FLUSHDB")


def encode_reply(value: Any, status: bool = False) -> bytes:
    """A RESP2 reply: ``status`` strings as ``+``, other strings bulk,
    ints ``:``, None a nil bulk, dicts and lists flat arrays, an
    exception an error."""
    if isinstance(value, BaseException):
        return b"-" + str(value).replace("\r\n", " ").encode() + b"\r\n"
    if value is None:
        return b"$-1\r\n"
    if isinstance(value, bool):
        return b":%d\r\n" % int(value)
    if isinstance(value, int):
        return b":%d\r\n" % value
    if isinstance(value, dict):
        value = [x for pair in value.items() for x in pair]
    if isinstance(value, (list, tuple)):
        return b"*%d\r\n" % len(value) + b"".join(encode_reply(v)
                                                   for v in value)
    raw = value if isinstance(value, bytes) else str(value).encode()
    if status:
        return b"+" + raw + b"\r\n"
    return b"$%d\r\n%s\r\n" % (len(raw), raw)


class RESPServer(_Server):
    """RESP2 in front of an ``InMemoryRedis`` (``.redis``): each command
    array runs through the engine's ``command``; an unknown command or a
    failing one answers an error reply."""

    name = "resp"

    def __init__(self, redis=None):
        if redis is None:
            from gofr_tpu_torch.datasource.redisx import InMemoryRedis
            from gofr_tpu_torch.logging import new_silent_logger
            from gofr_tpu_torch.metrics import Manager
            redis = InMemoryRedis(new_silent_logger(), Manager())
        self.redis = redis
        self.commands = 0
        super().__init__()

    def _line(self, conn, buffer: bytearray) -> Optional[bytes]:
        while b"\r\n" not in buffer:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            self.count(len(chunk))
            buffer += chunk
        line, _, rest = bytes(buffer).partition(b"\r\n")
        buffer[:] = rest
        return line

    def _exact(self, conn, buffer: bytearray, n: int) -> Optional[bytes]:
        while len(buffer) < n + 2:
            chunk = conn.recv(65536)
            if not chunk:
                return None
            self.count(len(chunk))
            buffer += chunk
        data = bytes(buffer[:n])
        buffer[:] = buffer[n + 2:]
        return data

    def serve(self, conn) -> None:
        buffer = bytearray()
        while self.running:
            line = self._line(conn, buffer)
            if line is None:
                return
            if not line.startswith(b"*"):
                return                      # RESP2 arrays only
            parts = []
            for _ in range(int(line[1:])):
                head = self._line(conn, buffer)
                if head is None or not head.startswith(b"$"):
                    return
                data = self._exact(conn, buffer, int(head[1:]))
                if data is None:
                    return
                parts.append(data.decode())
            if not parts:
                continue
            name = parts[0].upper()
            self.commands += 1
            try:
                reply = encode_reply(self.redis.command(*parts),
                                     status=name in _STATUS_COMMANDS)
            except AttributeError:
                reply = encode_reply(RuntimeError(
                    f"ERR unknown command '{parts[0]}'"))
            except Exception as exc:                        # noqa: BLE001
                reply = encode_reply(exc)
            self.send(conn, reply)


def main() -> int:
    servers = [KafkaLog(), MQTTBroker(), RESPServer()]
    for server in servers:
        print(f"{server.name} 127.0.0.1:{server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        for server in servers:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
