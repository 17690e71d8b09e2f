"""Redis datasource (a copy of ``gofr_tpu/datasource/redisx/client.py``):
a RESP2 wire client over a pooled socket, and ``InMemoryRedis``, an
in-process engine of the same commands that serves tests and
single-process apps (``REDIS_HOST=memory``). Every command is timed into
the ``app_redis_stats`` histogram.
"""

from __future__ import annotations

import fnmatch
import socket
import threading
import time
from typing import Any, Dict, List, Optional


class RedisError(Exception):
    pass


class _BaseRedis:
    """Command surface + observability shared by wire and memory engines."""

    def __init__(self, logger, metrics):
        self.logger = logger
        self.metrics = metrics

    def _observe(self, command: str, start: float) -> None:
        elapsed = time.perf_counter() - start
        self.metrics.record_histogram("app_redis_stats", elapsed,
                                      command=command)
        self.logger.debug("REDIS %s in %.3fms", command, elapsed * 1e3)

    def command(self, *parts) -> Any:
        raise NotImplementedError

    def _run(self, *parts) -> Any:
        start = time.perf_counter()
        try:
            return self.command(*parts)
        finally:
            self._observe(str(parts[0]).upper(), start)

    # -- the go-redis-ish surface the container exposes ---------------------
    def ping(self) -> bool:
        return self._run("PING") in ("PONG", True)

    def get(self, key: str) -> Optional[str]:
        return self._run("GET", key)

    def set(self, key: str, value: Any,
            ttl_seconds: Optional[float] = None) -> bool:
        if ttl_seconds is not None:
            return self._run("SET", key, value, "PX",
                             int(ttl_seconds * 1000)) == "OK"
        return self._run("SET", key, value) == "OK"

    def delete(self, *keys: str) -> int:
        return int(self._run("DEL", *keys))

    def exists(self, *keys: str) -> int:
        return int(self._run("EXISTS", *keys))

    def incr(self, key: str) -> int:
        return int(self._run("INCR", key))

    def decr(self, key: str) -> int:
        return int(self._run("DECR", key))

    def expire(self, key: str, ttl_seconds: float) -> bool:
        return int(self._run("PEXPIRE", key, int(ttl_seconds * 1000))) == 1

    def ttl(self, key: str) -> int:
        return int(self._run("TTL", key))

    def keys(self, pattern: str = "*") -> List[str]:
        return list(self._run("KEYS", pattern) or [])

    def hset(self, key: str, field: str, value: Any) -> int:
        return int(self._run("HSET", key, field, value))

    def hget(self, key: str, field: str) -> Optional[str]:
        return self._run("HGET", key, field)

    def hgetall(self, key: str) -> Dict[str, str]:
        flat = self._run("HGETALL", key) or []
        if isinstance(flat, dict):
            return flat
        return {flat[i]: flat[i + 1] for i in range(0, len(flat), 2)}

    def hsetnx(self, key: str, field: str, value: Any) -> bool:
        return int(self._run("HSETNX", key, field, value)) == 1

    def lpush(self, key: str, *values: Any) -> int:
        return int(self._run("LPUSH", key, *values))

    def rpush(self, key: str, *values: Any) -> int:
        return int(self._run("RPUSH", key, *values))

    def lpop(self, key: str) -> Optional[str]:
        return self._run("LPOP", key)

    def rpop(self, key: str) -> Optional[str]:
        return self._run("RPOP", key)

    def llen(self, key: str) -> int:
        return int(self._run("LLEN", key))

    def flushdb(self) -> bool:
        return self._run("FLUSHDB") == "OK"

    def pipeline(self, commands: List[tuple]) -> List[Any]:
        """Run a batch of raw commands; returns one result per command.
        An error reply occupies its slot as a ``RedisError`` instance
        instead of aborting the batch (go-redis pipeline semantics). The
        wire client overrides this with true RESP pipelining (one write,
        one round trip); this base version is the sequential fallback
        for the in-memory engine."""
        results: List[Any] = []
        for parts in commands:
            try:
                results.append(self._run(*parts))
            except RedisError as exc:
                results.append(exc)
        return results

    def health_check(self) -> Dict[str, Any]:
        try:
            up = self.ping()
            return {"status": "UP" if up else "DOWN",
                    "details": self._health_details()}
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": repr(exc)}}

    def _health_details(self) -> Dict[str, Any]:
        return {}

    def close(self) -> None:
        pass


class RedisClient(_BaseRedis):
    """RESP2 over a pooled TCP socket (original wire implementation)."""

    def __init__(self, config, logger, metrics):
        super().__init__(logger, metrics)
        self.host = config.get_or_default("REDIS_HOST", "localhost")
        self.port = config.get_int("REDIS_PORT", 6379)
        self._db = config.get_int("REDIS_DB", 0)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._buffer = b""
        self._connect()
        logger.info("redis connected %s:%d db=%d", self.host, self.port,
                    self._db)

    def _connect(self) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=5.0)
        self._buffer = b""
        if self._db:
            self._exchange("SELECT", self._db)

    # RESP2 encode/decode
    def _encode(self, parts) -> bytes:
        out = [b"*%d\r\n" % len(parts)]
        for part in parts:
            raw = part if isinstance(part, bytes) else str(part).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(raw), raw))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buffer:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buffer += chunk
        line, self._buffer = self._buffer.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buffer) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self._buffer += chunk
        data, self._buffer = self._buffer[:n], self._buffer[n + 2:]
        return data

    def _read_reply(self) -> Any:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RedisError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n).decode()
        if kind == b"*":
            n = int(rest)
            return None if n == -1 else [self._read_reply()
                                         for _ in range(n)]
        raise RedisError(f"bad RESP type byte {kind!r}")

    def _exchange(self, *parts) -> Any:
        self._sock.sendall(self._encode(parts))
        return self._read_reply()

    def command(self, *parts) -> Any:
        # Reconnect-and-reissue ONLY on transport failure (dead socket —
        # OSError covers ConnectionError). A server error reply (``-ERR``,
        # WRONGTYPE…) raises RedisError and must NOT retry: the connection
        # is healthy and reissuing a non-idempotent command (INCR, LPUSH)
        # would double-apply it.
        with self._lock:
            try:
                return self._exchange(*parts)
            except OSError:
                self._connect()  # one reconnect attempt then surface
                return self._exchange(*parts)

    def pipeline(self, commands: List[tuple]) -> List[Any]:
        """True RESP pipelining: every command is written in ONE send,
        then all replies are read back — one network round trip for the
        whole batch (reference RedisPipelineHandler's point). Reconnect-
        and-reissue happens only if the transport dies before ANY reply
        was consumed; after that, reissuing could double-apply the
        non-idempotent prefix, so the error surfaces instead."""
        if not commands:
            return []
        start = time.perf_counter()
        payload = b"".join(self._encode(parts) for parts in commands)
        results: List[Any] = []
        try:
            with self._lock:
                try:
                    self._sock.sendall(payload)
                    for _ in commands:
                        results.append(self._read_pipelined())
                except OSError:
                    if results:
                        raise   # partially applied: do not re-run
                    self._connect()
                    results = []
                    self._sock.sendall(payload)
                    for _ in commands:
                        results.append(self._read_pipelined())
            return results
        finally:
            self._observe("PIPELINE", start)

    def _read_pipelined(self) -> Any:
        try:
            return self._read_reply()
        except RedisError as exc:
            return exc

    def _health_details(self) -> Dict[str, Any]:
        return {"host": f"{self.host}:{self.port}", "db": self._db}

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass


class InMemoryRedis(_BaseRedis):
    """The miniredis: full command surface against process-local dicts with
    millisecond TTLs. Backs tests and ``REDIS_HOST=memory`` deployments."""

    def __init__(self, logger, metrics):
        super().__init__(logger, metrics)
        self._data: Dict[str, Any] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.RLock()

    def _alive(self, key: str) -> bool:
        deadline = self._expiry.get(key)
        if deadline is not None and time.monotonic() >= deadline:
            self._data.pop(key, None)
            self._expiry.pop(key, None)
        return key in self._data

    def command(self, *parts) -> Any:
        cmd = str(parts[0]).upper()
        args = [str(a) for a in parts[1:]]
        with self._lock:
            return getattr(self, f"_cmd_{cmd.lower()}")(*args)

    def _cmd_ping(self):
        return "PONG"

    def _cmd_select(self, db):
        return "OK"

    def _cmd_get(self, key):
        return self._data.get(key) if self._alive(key) else None

    def _cmd_set(self, key, value, *opts):
        self._data[key] = value
        self._expiry.pop(key, None)
        opts = [str(o).upper() if i % 2 == 0 else o
                for i, o in enumerate(opts)]
        if "PX" in opts:
            ms = float(opts[opts.index("PX") + 1])
            self._expiry[key] = time.monotonic() + ms / 1000.0
        if "EX" in opts:
            self._expiry[key] = time.monotonic() + float(
                opts[opts.index("EX") + 1])
        return "OK"

    def _cmd_setex(self, key, seconds, value):
        return self._cmd_set(key, value, "EX", seconds)

    def _cmd_del(self, *keys):
        n = 0
        for key in keys:
            if self._alive(key):
                del self._data[key]
                self._expiry.pop(key, None)
                n += 1
        return n

    def _cmd_exists(self, *keys):
        return sum(1 for k in keys if self._alive(k))

    def _cmd_incr(self, key):
        value = int(self._data.get(key, 0) if self._alive(key) else 0) + 1
        self._data[key] = str(value)
        return value

    def _cmd_decr(self, key):
        value = int(self._data.get(key, 0) if self._alive(key) else 0) - 1
        self._data[key] = str(value)
        return value

    def _cmd_pexpire(self, key, ms):
        if not self._alive(key):
            return 0
        self._expiry[key] = time.monotonic() + float(ms) / 1000.0
        return 1

    def _cmd_ttl(self, key):
        if not self._alive(key):
            return -2
        deadline = self._expiry.get(key)
        if deadline is None:
            return -1
        return max(0, int(deadline - time.monotonic()))

    def _cmd_keys(self, pattern):
        return [k for k in list(self._data) if self._alive(k)
                and fnmatch.fnmatch(k, pattern)]

    def _hash(self, key) -> Dict[str, str]:
        if not self._alive(key):
            self._data[key] = {}
        value = self._data[key]
        if not isinstance(value, dict):
            raise RedisError("WRONGTYPE")
        return value

    def _cmd_hset(self, key, field, value):
        mapping = self._hash(key)
        created = 0 if field in mapping else 1
        mapping[field] = value
        return created

    def _cmd_hget(self, key, field):
        return self._hash(key).get(field) if self._alive(key) else None

    def _cmd_hgetall(self, key):
        return dict(self._hash(key)) if self._alive(key) else {}

    def _cmd_hsetnx(self, key, field, value):
        mapping = self._hash(key)
        if field in mapping:
            return 0
        mapping[field] = value
        return 1

    def _list(self, key) -> List[str]:
        if not self._alive(key):
            self._data[key] = []
        value = self._data[key]
        if not isinstance(value, list):
            raise RedisError("WRONGTYPE")
        return value

    def _cmd_lpush(self, key, *values):
        lst = self._list(key)
        for v in values:
            lst.insert(0, v)
        return len(lst)

    def _cmd_rpush(self, key, *values):
        lst = self._list(key)
        lst.extend(values)
        return len(lst)

    def _cmd_lpop(self, key):
        lst = self._list(key)
        return lst.pop(0) if lst else None

    def _cmd_rpop(self, key):
        lst = self._list(key)
        return lst.pop() if lst else None

    def _cmd_llen(self, key):
        return len(self._list(key)) if self._alive(key) else 0

    def _cmd_flushdb(self):
        self._data.clear()
        self._expiry.clear()
        return "OK"

    def _health_details(self) -> Dict[str, Any]:
        return {"engine": "memory", "keys": len(self._data)}


def new_redis(config, logger, metrics):
    """REDIS_HOST=memory → in-process engine; anything else → RESP2 wire."""
    host = config.get_or_default("REDIS_HOST", "")
    if host in ("memory", ":memory:"):
        return InMemoryRedis(logger, metrics)
    return RedisClient(config, logger, metrics)
