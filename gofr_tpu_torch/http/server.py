"""Asyncio HTTP/1.1 server (a copy of ``gofr_tpu/http/server.py``): an
``asyncio.Protocol`` with keep-alive, content-length bodies, chunked
streams (SSE framing), a connection-upgrade hook, ``bound_port``, and a
shutdown that lets requests in flight finish within a drain grace.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Dict, Optional, Tuple

from gofr_tpu_torch.aio import spawn_logged
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.response import StreamBody

Dispatch = Callable[[Request], Awaitable[Tuple[int, Dict[str, str], bytes]]]

_STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    301: "Moved Permanently", 302: "Found", 304: "Not Modified",
    101: "Switching Protocols",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout",
    409: "Conflict", 413: "Payload Too Large", 426: "Upgrade Required",
    429: "Too Many Requests",
    500: "Internal Server Error", 502: "Bad Gateway",
    503: "Service Unavailable", 504: "Gateway Timeout",
}

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 64 * 1024 * 1024  # generous: image payloads for classify


class _HTTPProtocol(asyncio.Protocol):
    __slots__ = ("server", "transport", "buffer", "task", "peername",
                 "ws_feed", "closed", "busy", "_data_event")

    def __init__(self, server: "HTTPServer"):
        self.server = server
        self.transport: Optional[asyncio.Transport] = None
        self.buffer = bytearray()
        self.task: Optional[asyncio.Task] = None
        self.peername = ""
        self.ws_feed: Optional[Callable[[bytes], None]] = None
        self.closed = False
        self.busy = False    # between request parse and response write

    # -- asyncio.Protocol ---------------------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport
        peer = transport.get_extra_info("peername")
        self.peername = f"{peer[0]}:{peer[1]}" if peer else ""
        # _serve_loop answers protocol errors itself; the spawn_logged
        # callback catches the loop *infrastructure* dying (a bug in the
        # parser/writer), which would otherwise strand the connection
        self.task = spawn_logged(self._serve_loop(), self.server.logger,
                                 "http.serve_loop")
        self._data_event = asyncio.Event()
        self.server._connections.add(self)

    def data_received(self, data: bytes) -> None:
        if self.ws_feed is not None:
            self.ws_feed(bytes(data))
            return
        self.buffer.extend(data)
        self._data_event.set()

    def connection_lost(self, exc) -> None:
        self.closed = True
        self._data_event.set()
        self.server._connections.discard(self)
        if self.ws_feed is not None:
            self.ws_feed(b"")  # EOF signal
        if self.task is not None:
            self.task.cancel()

    # -- serve loop: sequential keep-alive requests -------------------------
    async def _serve_loop(self) -> None:
        try:
            while not self.closed:
                request = await self._read_request()
                if request is None:
                    break
                self.busy = True
                status, headers, body = await self.server.dispatch(request)
                keep_alive = request.headers.get("connection", "").lower() != "close"
                if self.server._draining:
                    keep_alive = False   # finish this response, then close
                upgrade = request.context_values.get("upgrade_protocol")
                if isinstance(body, StreamBody):
                    keep_alive = await self._write_stream(
                        status, headers, body, keep_alive)
                    self.busy = False
                    # drain may have BEGUN while the stream was writing
                    # (keep_alive was computed before): without this
                    # re-check the connection would park idle and
                    # wait_closed() would never return
                    if self.server._draining:
                        keep_alive = False
                    if not keep_alive:
                        break
                    continue
                self._write_response(status, headers, body,
                                     keep_alive and upgrade is None)
                self.busy = False
                if upgrade is not None and status == 101:
                    # Hand the connection over (websocket). `upgrade` is an
                    # async callable(transport, set_feed) that runs the
                    # connection until it closes.
                    await upgrade(self.transport, self._set_ws_feed)
                    break
                if not keep_alive:
                    break
        except asyncio.CancelledError:
            pass
        except Exception as exc:  # never let a parse error kill the loop
            self.server.log_error(f"connection error from {self.peername}: {exc!r}")
        finally:
            if self.transport is not None and not self.transport.is_closing():
                self.transport.close()

    def _set_ws_feed(self, feed: Optional[Callable[[bytes], None]]) -> bytes:
        """Switch raw-byte routing to the websocket layer; returns any bytes
        already buffered past the handshake."""
        self.ws_feed = feed
        leftover = bytes(self.buffer)
        self.buffer.clear()
        return leftover

    async def _read_request(self) -> Optional[Request]:
        header_end = -1
        while True:
            header_end = self.buffer.find(b"\r\n\r\n")
            if header_end >= 0:
                break
            if self.closed:
                return None
            if len(self.buffer) > _MAX_HEADER_BYTES:
                self._write_response(400, {}, b"header too large", False)
                return None
            await self._wait_data()
        head = bytes(self.buffer[:header_end])
        del self.buffer[:header_end + 4]

        lines = head.split(b"\r\n")
        try:
            method, target, _version = lines[0].decode("latin-1").split(" ", 2)
        except ValueError:
            self._write_response(400, {}, b"malformed request line", False)
            return None
        headers: Dict[str, str] = {}
        for line in lines[1:]:
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()

        try:
            length = int(headers.get("content-length", "0") or "0")
        except ValueError:
            self._write_response(400, {}, b"malformed content-length", False)
            return None
        if length < 0:
            self._write_response(400, {}, b"malformed content-length", False)
            return None
        if length > _MAX_BODY_BYTES:
            self._write_response(413, {}, b"body too large", False)
            return None
        while len(self.buffer) < length:
            if self.closed:
                return None
            await self._wait_data()
        body = bytes(self.buffer[:length])
        del self.buffer[:length]

        path, _, query = target.partition("?")
        return Request(method=method.upper(), path=path or "/", query=query,
                       headers=headers, body=body, remote_addr=self.peername)

    async def _wait_data(self) -> None:
        self._data_event.clear()
        await self._data_event.wait()

    @staticmethod
    def _serialize_head(status: int, headers: Dict[str, str],
                        extra: Tuple[str, ...] = (),
                        skip: Tuple[str, ...] = ()) -> Tuple[str, bool]:
        """Serialize the status line + headers. Returns (head text without
        the final blank line, whether a Connection header was present).
        ``skip`` filters caller-managed headers; ``extra`` appends raw
        header lines."""
        reason = _STATUS_TEXT.get(status, "Unknown")
        parts = [f"HTTP/1.1 {status} {reason}\r\n"]
        sent_connection = False
        for name, value in headers.items():
            low = name.lower()
            if low in skip:
                continue
            if low == "connection":
                sent_connection = True
            parts.append(f"{name}: {value}\r\n")
        parts.extend(extra)
        return "".join(parts), sent_connection

    async def _write_stream(self, status: int, headers: Dict[str, str],
                            body: StreamBody, keep_alive: bool) -> bool:
        """Write a chunked-transfer response, flushing each item of the
        async iterator as its own chunk (SSE items get ``data:`` framing).
        Returns whether the connection may be kept alive: a producer error
        mid-stream forces a close so the client sees truncation instead of
        a silently-complete body. Fires ``body.complete(ok, messages)``
        for middleware observers, and closes the producer iterator on
        early exit so an abandoned stream stops generating."""
        if self.transport is None or self.transport.is_closing():
            if hasattr(body.chunks, "aclose"):
                # never started: still release the producer so an admitted
                # generation request frees its slot
                try:
                    await body.chunks.aclose()
                except Exception:  # noqa: BLE001
                    pass
            body.complete(False, 0)
            return False
        head, _ = self._serialize_head(
            status, headers,
            extra=("Transfer-Encoding: chunked\r\n",
                   "Connection: keep-alive\r\n" if keep_alive
                   else "Connection: close\r\n"),
            skip=("content-length", "connection", "transfer-encoding"))
        self.transport.write((head + "\r\n").encode("latin-1"))
        count = 0
        ok = False            # stream fully delivered (terminator written)
        client_gone = False   # client disconnected: not a server failure
        try:
            async for item in body.chunks:
                if self.closed or self.transport.is_closing():
                    client_gone = True
                    break          # stop producing
                if isinstance(item, str):
                    item = item.encode()
                if body.sse:
                    item = b"data: " + item + b"\n\n"
                if not item:
                    continue
                count += 1
                self.transport.write(b"%x\r\n%s\r\n" % (len(item), item))
            if not client_gone and not self.closed \
                    and not self.transport.is_closing():
                self.transport.write(b"0\r\n\r\n")
                ok = True
        except asyncio.CancelledError:
            # connection_lost cancels the serve task mid-await: a client
            # disconnect, not a producer failure
            client_gone = True
            raise
        except Exception as exc:  # noqa: BLE001 — mid-stream failure
            self.server.log_error(f"stream aborted for {self.peername}: "
                                  f"{exc!r}")
        finally:
            if not ok and hasattr(body.chunks, "aclose"):
                # early exit (client gone / producer error): release the
                # producer so e.g. a generation slot stops decoding
                try:
                    await body.chunks.aclose()
                except Exception:  # noqa: BLE001
                    pass
            # observers see ok for client disconnects too: the producer
            # did not fail, so the header status is the honest record
            body.complete(ok or client_gone, count)
        return keep_alive if ok else False

    def _write_response(self, status: int, headers: Dict[str, str],
                        body: bytes, keep_alive: bool) -> None:
        if self.transport is None or self.transport.is_closing():
            return
        extra = []
        head, sent_connection = self._serialize_head(status, headers)
        if status != 101:
            extra.append(f"Content-Length: {len(body)}\r\n")
            if not sent_connection:
                extra.append(
                    "Connection: keep-alive\r\n" if keep_alive
                    else "Connection: close\r\n")
        self.transport.write(
            (head + "".join(extra) + "\r\n").encode("latin-1") + body)


class HTTPServer:
    """Bind/serve wrapper (reference: httpServer.go:39-51 Run)."""

    def __init__(self, dispatch: Dispatch, port: int, host: str = "0.0.0.0",
                 logger=None):
        self.dispatch = dispatch
        self.port = port
        self.host = host
        self.logger = logger
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()
        self._draining = False

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _HTTPProtocol(self), self.host, self.port,
            reuse_address=True, backlog=2048,
        )
        if self.logger is not None:
            self.logger.info("HTTP server listening on %s:%d", self.host, self.port)

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        await self._server.serve_forever()

    async def shutdown(self, drain_grace: float = 5.0) -> None:
        if self._server is not None:
            self._server.close()
            # Python 3.12's Server.wait_closed() waits for every live
            # handler — a connected websocket (or an idle keep-alive
            # client) would park shutdown forever. Graceful drain: close
            # truly idle and upgraded (websocket) connections now;
            # connections mid-request — including a partially-received
            # request (non-empty parse buffer) — finish their response
            # first (the serve loop sees _draining and closes after
            # writing). Stragglers that never finish within
            # ``drain_grace`` seconds are force-closed so shutdown is
            # always bounded.
            self._draining = True
            for protocol in list(self._connections):
                if protocol.transport is None:
                    continue
                if protocol.ws_feed is not None or (
                        not protocol.busy and not protocol.buffer):
                    protocol.transport.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(),
                                       drain_grace)
            except asyncio.TimeoutError:
                for protocol in list(self._connections):
                    if protocol.transport is not None:
                        protocol.transport.close()
                await self._server.wait_closed()
            self._server = None
            self._draining = False

    def log_error(self, message: str) -> None:
        if self.logger is not None:
            self.logger.error(message)

    @property
    def bound_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port
