"""Responder: map handler results to wire responses (a copy of
``gofr_tpu/http/responder.py``): ``Raw``/``FileResponse``/``Stream``/
``Redirect``/``Response``, or the ``{"data": ...}`` envelope with POST →
201 and DELETE → 204; errors with a ``status_code`` (duck-typed, so the
port's ``DeadlineExceeded`` is a 503) as ``{"error": {"message": ...}}``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, is_dataclass
from typing import Any, Dict, Optional, Tuple

from gofr_tpu_torch.http.errors import HTTPError
from gofr_tpu_torch.http.response import (FileResponse, Raw, Redirect, Response,
                                    Stream, StreamBody)


def _jsonable(obj: Any) -> Any:
    if is_dataclass(obj) and not isinstance(obj, type):
        return asdict(obj)
    if hasattr(obj, "to_json"):
        return obj.to_json()
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if hasattr(obj, "tolist"):  # numpy arrays, tensors
        # graftcheck: ignore[GT001] — a handler's result is serialized on
        # the loop, as JAX's responder does (``tolist`` of a jax.Array
        # there): a handler that returns a device tensor pays its sync
        # here (ROADMAP §3, "The responder serializes on the loop")
        return obj.tolist()
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in vars(obj).items()
                if not k.startswith("_")}
    return obj


class Responder:
    """Builds (status, headers, body) triples from handler (result, error)."""

    def respond(self, result: Any, error: Optional[Exception],
                method: str = "GET") -> Tuple[int, Dict[str, str], bytes]:
        if error is not None:
            return self._error_response(error)

        if isinstance(result, Response):
            headers = dict(result.headers)
            if isinstance(result.data, (bytes, bytearray)):
                headers.setdefault("Content-Type",
                                   result.content_type or "application/octet-stream")
                return result.status_code, headers, bytes(result.data)
            body = json.dumps(_jsonable(result.data)).encode()
            headers.setdefault("Content-Type",
                               result.content_type or "application/json")
            return result.status_code, headers, body

        if isinstance(result, Stream):
            headers = dict(result.headers)
            headers.setdefault(
                "Content-Type",
                "text/event-stream" if result.sse else result.content_type)
            if result.sse:
                headers.setdefault("Cache-Control", "no-cache")
            body = StreamBody(result.chunks, sse=result.sse)
            if result.on_close is not None:
                on_close = result.on_close
                body.on_complete(lambda ok, messages: on_close())
            return result.status_code, headers, body

        if isinstance(result, FileResponse):
            return 200, {"Content-Type": result.content_type}, result.content

        if isinstance(result, Redirect):
            return result.status_code, {"Location": result.location}, b""

        if isinstance(result, Raw):
            body = json.dumps(_jsonable(result.data)).encode()
            return 200, {"Content-Type": "application/json"}, body

        # default envelope + method-based status (responder.go:51-78)
        status = {"POST": 201, "DELETE": 204}.get(method, 200)
        if result is None and method == "DELETE":
            return 204, {}, b""
        envelope = {"data": _jsonable(result)}
        body = json.dumps(envelope).encode()
        return status, {"Content-Type": "application/json"}, body

    def _error_response(self, error: Exception) -> Tuple[int, Dict[str, str], bytes]:
        if isinstance(error, HTTPError):
            status = error.status_code
            message = error.message
        elif hasattr(error, "status_code"):
            status = int(error.status_code)  # duck-typed custom errors
            message = str(error)
        else:
            status = 500
            message = str(error) or "internal server error"
        body = json.dumps({"error": {"message": message}}).encode()
        return status, {"Content-Type": "application/json"}, body
