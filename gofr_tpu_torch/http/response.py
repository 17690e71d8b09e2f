"""Response value types (a copy of ``gofr_tpu/http/response.py``): ``Raw``
(no envelope), ``FileResponse``, ``Redirect``, ``Response``, ``Stream``
(chunked, optionally Server-Sent Events) and the wire marker
``StreamBody``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class Raw:
    """Return the payload as-is, skipping the ``{"data": ...}`` envelope
    (reference: response/raw.go)."""

    data: Any


@dataclass
class FileResponse:
    """Serve raw bytes with a content type (reference: response/file.go)."""

    content: bytes
    content_type: str = "application/octet-stream"


@dataclass
class Redirect:
    location: str
    status_code: int = 302


@dataclass
class Response:
    """Fully-specified response: body + status + headers."""

    data: Any = None
    status_code: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    content_type: Optional[str] = None


@dataclass
class Stream:
    """Incrementally-written response body (chunked transfer encoding).

    ``chunks`` is an async iterator (or async generator) of ``bytes`` /
    ``str``; each item is flushed to the client as its own chunk the
    moment it is yielded — this is the token-streaming surface for
    ``/generate``.
    ``sse=True`` wraps each item as a Server-Sent-Events ``data:`` frame
    and sets ``text/event-stream``.

    ``on_close`` (optional, sync) fires exactly once when the response
    finishes — including paths where the chunk iterator is never started
    (client gone before the first write), where a generator ``finally``
    cannot run. Use it to release the underlying producer, e.g.
    ``TokenStream.cancel``.
    """

    chunks: Any
    content_type: str = "application/octet-stream"
    sse: bool = False
    status_code: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    on_close: Optional[Any] = None


class StreamBody:
    """Wire-level marker the HTTP protocol writes incrementally: carries
    the async chunk iterator through the (status, headers, body) middleware
    contract, which treats the body as opaque.

    Middleware can't time a stream from the (status, headers, body) tuple —
    the body hasn't been produced yet when dispatch returns — so observers
    registered via ``on_complete`` fire when the protocol finishes (or
    aborts) the stream, carrying ``(ok, messages)``. The logging/metrics
    middlewares use this to record true stream duration and a 500 status
    on mid-stream producer failure instead of a near-zero 200."""

    __slots__ = ("chunks", "sse", "_observers", "_completed")

    def __init__(self, chunks, sse: bool = False):
        self.chunks = chunks
        self.sse = sse
        self._observers = []
        self._completed = False

    def on_complete(self, fn) -> None:
        """``fn(ok: bool, messages: int)`` fires once at stream end."""
        self._observers.append(fn)

    def complete(self, ok: bool, messages: int) -> None:
        if self._completed:
            return
        self._completed = True
        for fn in self._observers:
            try:
                fn(ok, messages)
            except Exception:  # noqa: BLE001 — observers must not break IO
                pass

    def __len__(self) -> int:   # middleware/logging may size the body
        return 0
