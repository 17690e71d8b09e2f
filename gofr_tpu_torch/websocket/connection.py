"""A websocket connection that is also a request, so a ``Context`` over
it works in any handler; and the hub of live connections keyed by
``Sec-WebSocket-Key`` (counterpart of ``gofr_tpu/websocket/connection.py``).

Frames are fed in on the event loop and written straight to the
transport: the connection is used from the loop only.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Any, Dict, List, Optional

from gofr_tpu_torch.websocket.frames import (
    OP_BINARY,
    OP_CLOSE,
    OP_CONT,
    OP_PING,
    OP_PONG,
    OP_TEXT,
    FrameTooLarge,
    ProtocolError,
    decode_frame,
    encode_close,
    encode_frame,
)

# the most one message (a frame, or reassembled fragments) may hold: a
# client can neither declare a 2**63-byte frame nor stream fragments
# without end
DEFAULT_MAX_MESSAGE_BYTES = 16 * 1024 * 1024


class ConnectionClosed(Exception):
    pass


class Connection:
    def __init__(self, transport, key: str, path: str,
                 path_params: Optional[Dict[str, str]] = None,
                 query_params: Optional[Dict[str, List[str]]] = None,
                 max_message_bytes: int = DEFAULT_MAX_MESSAGE_BYTES):
        self.transport = transport
        self.key = key
        self.path = path
        self.path_params = path_params or {}
        self._query = query_params or {}
        self._buffer = bytearray()
        self._messages: asyncio.Queue = asyncio.Queue()
        self._fragments: List[bytes] = []
        self._fragment_len = 0
        self._fragment_op = OP_TEXT
        self.max_message_bytes = max_message_bytes
        self.closed = False

    # -- bytes from the HTTP connection ---------------------------------------
    def feed(self, data: bytes) -> None:
        if not data:  # EOF
            self.closed = True
            self._messages.put_nowait(None)
            return
        self._buffer.extend(data)
        while True:
            try:
                frame = decode_frame(bytes(self._buffer),
                                     max_length=self.max_message_bytes,
                                     require_mask=True)
            except ProtocolError as exc:
                self._fail(exc)
                return
            if frame is None:
                return
            opcode, fin, payload, consumed = frame
            del self._buffer[:consumed]
            self._on_frame(opcode, fin, payload)

    def _fail(self, exc: ProtocolError) -> None:
        """Fail the connection (RFC 6455 §7.1.7): a close frame with the
        violation's code (1002 or 1009), no more reading, the transport
        dropped."""
        if not self.closed:
            self._send_raw(encode_close(exc.close_code,
                                        str(exc).encode()[:120]))
            self.closed = True
        self._buffer.clear()
        self._fragments = []
        self._fragment_len = 0
        self._messages.put_nowait(None)
        if self.transport is not None and not self.transport.is_closing():
            self.transport.close()

    def _on_frame(self, opcode: int, fin: bool, payload: bytes) -> None:
        if opcode == OP_PING:
            self._send_raw(encode_frame(OP_PONG, payload))
            return
        if opcode == OP_PONG:
            return
        if opcode == OP_CLOSE:
            if not self.closed:
                self._send_raw(encode_frame(OP_CLOSE, payload))
                self.closed = True
            self._messages.put_nowait(None)
            return
        if opcode in (OP_TEXT, OP_BINARY):
            if fin:
                self._deliver(opcode, payload)
            else:
                self._fragments = [payload]
                self._fragment_len = len(payload)
                self._fragment_op = opcode
            return
        if opcode == OP_CONT:
            self._fragment_len += len(payload)
            if self._fragment_len > self.max_message_bytes:
                self._fail(FrameTooLarge(
                    f"fragmented message exceeds {self.max_message_bytes}"))
                return
            self._fragments.append(payload)
            if fin:
                data = b"".join(self._fragments)
                self._fragments = []
                self._fragment_len = 0
                self._deliver(self._fragment_op, data)

    def _deliver(self, opcode: int, payload: bytes) -> None:
        message = payload.decode("utf-8", "replace") \
            if opcode == OP_TEXT else payload
        self._messages.put_nowait(message)

    def _send_raw(self, data: bytes) -> None:
        if self.transport is not None and not self.transport.is_closing():
            self.transport.write(data)

    # -- the handler's side ---------------------------------------------------
    async def read_message(self) -> Any:
        if self.closed and self._messages.empty():
            raise ConnectionClosed()
        message = await self._messages.get()
        if message is None:
            raise ConnectionClosed()
        return message

    async def write_message(self, data: Any) -> None:
        if self.closed:
            raise ConnectionClosed()
        if isinstance(data, (bytes, bytearray)):
            self._send_raw(encode_frame(OP_BINARY, bytes(data)))
        else:
            if not isinstance(data, str):
                data = json.dumps(data)
            self._send_raw(encode_frame(OP_TEXT, data.encode()))

    def close(self) -> None:
        if not self.closed:
            self._send_raw(encode_frame(OP_CLOSE, b""))
            self.closed = True
        if self.transport is not None and not self.transport.is_closing():
            self.transport.close()

    # -- the request contract, so a Context works unchanged --------------------
    def param(self, key: str) -> str:
        values = self._query.get(key)
        return values[0] if values else ""

    def params(self, key: str) -> List[str]:
        return self._query.get(key, [])

    def path_param(self, key: str) -> str:
        return self.path_params.get(key, "")

    def bind(self, target: Any = None) -> Any:
        raise TypeError("use `await ctx.read_message()` on websocket routes")

    def header(self, key: str) -> str:
        return ""

    @property
    def method(self) -> str:
        return "WS"


class ConnectionHub:
    """The live connections, keyed by ``Sec-WebSocket-Key``; safe to use
    from any thread."""

    def __init__(self):
        self._connections: Dict[str, Connection] = {}
        self._lock = threading.Lock()

    def add(self, connection: Connection) -> None:
        with self._lock:
            self._connections[connection.key] = connection

    def remove(self, key: str) -> None:
        with self._lock:
            self._connections.pop(key, None)

    def get(self, key: str) -> Optional[Connection]:
        with self._lock:
            return self._connections.get(key)

    def all(self) -> List[Connection]:
        with self._lock:
            return list(self._connections.values())

    async def broadcast(self, message: Any) -> None:
        for connection in self.all():
            try:
                await connection.write_message(message)
            except ConnectionClosed:
                self.remove(connection.key)
