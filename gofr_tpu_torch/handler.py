"""Handler adapter: user handler → wire handler (a copy of
``gofr_tpu/handler.py``), with a timeout and panic isolation, plus the
health, alive, favicon and catch-all handlers.

Async handlers run on the loop (under ``asyncio.wait_for`` with a
timeout); plain ``def`` handlers run through ``asyncio.to_thread``, which
carries the contextvars (the port's request deadline and span) into the
worker thread, where ``run_in_executor`` would not. An escaped exception
becomes a 500, or its own ``status_code`` (the port's
``DeadlineExceeded`` is a 503).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Callable, Optional

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.http.errors import HTTPError, InvalidRoute, PanicRecovery, RequestTimeout
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import Responder
from gofr_tpu_torch.slo import parse_deadline_header, set_request_deadline

Handler = Callable[[Context], Any]

_responder = Responder()


def wrap_handler(func: Handler, container, timeout: Optional[float] = None):
    """Build the wire handler for one route (handler.go:43-96)."""
    is_async = asyncio.iscoroutinefunction(func)

    async def wire_handler(request: Request):
        ctx = Context(request, container, _responder)
        # deadline budget (X-Request-Deadline-Ms) -> absolute monotonic
        # instant in the port's contextvar; to_thread propagates
        # contextvars, so the batcher and the engine see it from both
        # async and sync handlers
        set_request_deadline(
            parse_deadline_header(request.header("X-Request-Deadline-Ms")))
        try:
            if is_async:
                coro: Any = func(ctx)
            else:
                # to_thread propagates contextvars into the worker thread
                # (plain run_in_executor does NOT), so outbound service
                # calls from sync handlers continue the inbound trace
                coro = asyncio.to_thread(func, ctx)
            if timeout is not None and timeout > 0:
                result = await asyncio.wait_for(coro, timeout)
            else:
                result = await coro
            if asyncio.iscoroutine(result):  # sync handler returned a coro
                result = await result
            error = None
        except asyncio.TimeoutError:
            result, error = None, RequestTimeout()
        except HTTPError as exc:
            result, error = None, exc
        except Exception as exc:  # "panic" isolation (handler.go:71-92)
            container.logger.error("handler panic: %r", exc,
                                   uri=request.path, method=request.method)
            if hasattr(exc, "status_code"):
                result, error = None, exc
            else:
                # generic body (reference ErrorPanicRecovery): the real
                # exception is logged above, never leaked to the client
                result, error = None, PanicRecovery()
        return _responder.respond(result, error, request.method)

    return wire_handler


# -- built-in handlers (handler.go:98-126) ----------------------------------

def make_health_handler(container):
    async def health_handler(request: Request):
        loop = asyncio.get_running_loop()
        body = await loop.run_in_executor(None, container.health)
        return 200, {"Content-Type": "application/json"}, json.dumps(body).encode()
    return health_handler


async def live_handler(request: Request):
    return 200, {"Content-Type": "application/json"}, b'{"status":"UP"}'


_FAVICON: "bytes | None" = None    # None = not read yet; b"" = unavailable


async def favicon_handler(request: Request):
    """Serve the bundled icon (``static/favicon.ico``), read once: a failed
    read too, so a missing file costs one syscall in all."""
    global _FAVICON
    if _FAVICON is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "static",
                            "favicon.ico")
        try:
            # graftcheck: ignore[GT001] — one ~4KB local read, cached for
            # the process lifetime; a thread hop would cost more than it
            with open(path, "rb") as fh:
                _FAVICON = fh.read()
        except OSError:
            _FAVICON = b""
    if not _FAVICON:
        return 204, {}, b""
    return 200, {"Content-Type": "image/x-icon",
                 "Cache-Control": "public, max-age=86400"}, _FAVICON


async def catch_all_handler(request: Request):
    return _responder.respond(None, InvalidRoute(), request.method)
