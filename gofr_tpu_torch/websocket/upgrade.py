"""The websocket upgrade route: the handshake, then the connection's
loop (counterpart of ``gofr_tpu/websocket/upgrade.py``).

The hub is one a process, as JAX's is. The handler runs on the event
loop, a plain ``def`` too: the connection writes its transport directly
and is not safe to use from another thread.
"""

from __future__ import annotations

import asyncio
import urllib.parse

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.websocket.connection import (Connection,
                                                 ConnectionClosed,
                                                 ConnectionHub)
from gofr_tpu_torch.websocket.frames import accept_key

_hub = ConnectionHub()


def hub() -> ConnectionHub:
    return _hub


def make_ws_route(handler, container):
    """The wire handler of a websocket route: 101 and an
    ``upgrade_protocol`` continuation that the HTTP server runs once the
    protocol is switched."""

    async def ws_wire_handler(request):
        if request.headers.get("upgrade", "").lower() != "websocket":
            return 426, {"Content-Type": "text/plain"}, b"upgrade required"
        key = request.headers.get("sec-websocket-key", "")
        if not key:
            return 400, {}, b"missing Sec-WebSocket-Key"

        query = urllib.parse.parse_qs(request.query or "")

        async def run_connection(transport, set_feed):
            connection = Connection(transport, key, request.path,
                                    path_params=dict(request.path_params),
                                    query_params=query)
            leftover = set_feed(connection.feed)
            if leftover:
                connection.feed(leftover)
            _hub.add(connection)
            ctx = Context(connection, container)
            try:
                result = handler(ctx)
                if asyncio.iscoroutine(result):
                    await result
            except ConnectionClosed:
                pass
            except Exception as exc:
                container.logger.error("websocket handler panic: %r", exc)
            finally:
                _hub.remove(key)
                connection.close()
                set_feed(None)

        request.context_values["upgrade_protocol"] = run_connection
        return 101, {
            "Upgrade": "websocket",
            "Connection": "Upgrade",
            "Sec-WebSocket-Accept": accept_key(key),
        }, b""

    return ws_wire_handler
