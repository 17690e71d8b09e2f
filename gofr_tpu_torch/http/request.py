"""Transport-level HTTP request object (a copy of
``gofr_tpu/http/request.py``): query and path params, ``bind`` by content
type (JSON, form, multipart, a zero-copy numpy view for
``application/x-tensor``), host name, headers. It is the request contract
``gofr_tpu_torch.context.Context`` consumes.
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from gofr_tpu_torch.http.errors import InvalidParam


@dataclass
class Request:
    method: str = "GET"
    path: str = "/"
    query: str = ""
    headers: Dict[str, str] = field(default_factory=dict)  # lower-cased keys
    body: bytes = b""
    path_params: Dict[str, str] = field(default_factory=dict)
    # matched route template (``/users/{id}``), set by dispatch; the
    # bounded identity metrics label by — raw ``path`` is per-request
    route: str = ""
    remote_addr: str = ""
    # set by middleware:
    context_values: Dict[str, Any] = field(default_factory=dict)

    _query_cache: Optional[Dict[str, List[str]]] = field(default=None, repr=False)

    # -- the transport-agnostic Request contract ---------------------------
    def param(self, key: str) -> str:
        """First query-string value for ``key`` (request.go:42-45)."""
        values = self._parsed_query().get(key)
        return values[0] if values else ""

    def params(self, key: str) -> List[str]:
        return self._parsed_query().get(key, [])

    def path_param(self, key: str) -> str:
        """Path parameter from the matched route (request.go:51-54)."""
        return self.path_params.get(key, "")

    def bind(self, target: Any = None) -> Any:
        """Decode the body by content type (request.go:57-74).

        - ``application/json`` → parsed object; if ``target`` is a dataclass
          or plain class, fields are set from the JSON object.
        - ``application/x-www-form-urlencoded`` → dict of first values.
        - ``multipart/form-data`` → dict of form fields + ``UploadedFile``s.
        - ``application/x-tensor`` → zero-copy numpy **view** over the
          socket bytes, dtype/shape from ``X-Tensor-Dtype`` /
          ``X-Tensor-Shape`` headers — the bytes are copied exactly once
          afterwards, into the executor's staging slab.
        - anything else → the raw ``bytes`` body, unchanged (zero-copy
          ingest is opted into via the tensor content types above, so
          existing handlers that ``.decode()``/``json.loads`` the raw
          body keep working).
        """
        ctype = self.headers.get("content-type", "application/json").split(";")[0].strip()
        if ctype in ("application/json", ""):
            try:
                data = json.loads(self.body.decode("utf-8")) if self.body else {}
            except (ValueError, UnicodeDecodeError) as exc:
                raise InvalidParam(["body"]) from exc
        elif ctype == "application/x-www-form-urlencoded":
            parsed = urllib.parse.parse_qs(self.body.decode("utf-8", "replace"))
            data = {k: v[0] for k, v in parsed.items()}
        elif ctype == "multipart/form-data":
            data = self._parse_multipart()
        elif ctype in ("application/x-tensor", "application/x-gofr-tensor"):
            data = self._bind_tensor()
        else:
            data = self.body
        if target is None:
            return data
        return _bind_into(target, data)

    def _bind_tensor(self) -> Any:
        """Binary tensor ingest (the zero-copy data plane): interpret
        the body as one array without copying it — ``np.frombuffer`` views
        the socket buffer. The view is read-only; the staging slab write
        downstream is the single host copy the request ever pays."""
        import numpy as np
        try:
            dtype = np.dtype(self.headers.get("x-tensor-dtype", "uint8"))
        except TypeError as exc:
            raise InvalidParam(["x-tensor-dtype"]) from exc
        shape_header = self.headers.get("x-tensor-shape", "").strip()
        try:
            shape = tuple(int(v) for v in shape_header.split(",") if v != "")
        except ValueError as exc:
            raise InvalidParam(["x-tensor-shape"]) from exc
        try:
            arr = np.frombuffer(self.body, dtype=dtype)
            return arr.reshape(shape) if shape else arr
        except ValueError as exc:
            raise InvalidParam(["body"]) from exc

    def host_name(self) -> str:
        """scheme://host, honouring X-Forwarded-Proto (request.go:77-84)."""
        proto = self.headers.get("x-forwarded-proto", "http")
        return f"{proto}://{self.headers.get('host', 'localhost')}"

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    # -- internals ----------------------------------------------------------
    def _parsed_query(self) -> Dict[str, List[str]]:
        if self._query_cache is None:
            self._query_cache = urllib.parse.parse_qs(self.query, keep_blank_values=True)
        return self._query_cache

    def _parse_multipart(self) -> Dict[str, Any]:
        """Minimal RFC 2046 multipart/form-data parser (reference analog:
        multipartFileBind.go mapping FileHeaders + form fields)."""
        ctype = self.headers.get("content-type", "")
        boundary = None
        for part in ctype.split(";"):
            part = part.strip()
            if part.startswith("boundary="):
                boundary = part[len("boundary="):].strip('"')
        if not boundary:
            raise InvalidParam(["content-type: missing multipart boundary"])
        delim = b"--" + boundary.encode()
        out: Dict[str, Any] = {}
        for chunk in self.body.split(delim):
            chunk = chunk.strip(b"\r\n")
            if not chunk or chunk == b"--":
                continue
            header_blob, _, payload = chunk.partition(b"\r\n\r\n")
            headers: Dict[str, str] = {}
            for line in header_blob.split(b"\r\n"):
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            disposition = headers.get("content-disposition", "")
            field_name, filename = _parse_disposition(disposition)
            if filename is not None:
                out[field_name] = UploadedFile(
                    filename=filename,
                    content_type=headers.get("content-type", "application/octet-stream"),
                    content=payload,
                )
            elif field_name:
                out[field_name] = payload.decode("utf-8", "replace")
        return out


@dataclass
class UploadedFile:
    """A file part from multipart/form-data (reference analog:
    multipart.FileHeader bound by multipartFileBind.go:17-40)."""

    filename: str
    content_type: str
    content: bytes


def _parse_disposition(value: str):
    field_name, filename = "", None
    for part in value.split(";"):
        part = part.strip()
        if part.startswith("name="):
            field_name = part[len("name="):].strip('"')
        elif part.startswith("filename="):
            filename = part[len("filename="):].strip('"')
    return field_name, filename


def _bind_into(target: Any, data: Any) -> Any:
    """Populate ``target`` from decoded body data.

    Accepts a class (instantiated with **data for dataclasses, or attribute
    assignment) or an instance (attributes set). The reference uses Go JSON
    unmarshalling into a struct pointer (request.go:57-63); duck-typed
    attribute binding is the Python analog.
    """
    if not isinstance(data, dict):
        return data
    if isinstance(target, type):
        try:
            return target(**data)
        except TypeError:
            instance = target()
            for key, value in data.items():
                setattr(instance, key, value)
            return instance
    for key, value in data.items():
        setattr(target, key, value)
    return target
