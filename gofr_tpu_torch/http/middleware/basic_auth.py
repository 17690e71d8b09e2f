"""HTTP Basic auth middleware
(a copy of ``gofr_tpu/http/middleware/basic_auth.py``): a user map or a
validator (with the container when one is given); ``/.well-known/``
paths pass.
"""

from __future__ import annotations

import base64
import hmac
import json
from typing import Callable, Dict, Optional

from gofr_tpu_torch.http.router import Middleware, WireHandler


def _is_well_known(path: str) -> bool:
    return path.startswith("/.well-known/")


def _unauthorized():
    body = json.dumps({"error": {"message": "Unauthorized"}}).encode()
    return 401, {"Content-Type": "application/json",
                 "WWW-Authenticate": 'Basic realm="gofr-tpu"'}, body


def basic_auth_middleware(
    users: Optional[Dict[str, str]] = None,
    validate: Optional[Callable[..., bool]] = None,
    container=None,
) -> Middleware:
    """``users`` is a username→password map; ``validate`` is a callback
    ``(user, password) -> bool`` or, when a container is supplied,
    ``(container, user, password) -> bool`` (basic_auth.go:25-43)."""

    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            if _is_well_known(request.path):
                return await next_handler(request)
            header = request.headers.get("authorization", "")
            if not header.startswith("Basic "):
                return _unauthorized()
            try:
                decoded = base64.b64decode(header[6:]).decode("utf-8")
                user, _, password = decoded.partition(":")
            except Exception:
                return _unauthorized()
            ok = False
            if validate is not None:
                ok = validate(container, user, password) if container is not None \
                    else validate(user, password)
            elif users is not None:
                expected = users.get(user)
                ok = expected is not None and hmac.compare_digest(expected, password)
            if not ok:
                return _unauthorized()
            request.context_values["auth_user"] = user
            return await next_handler(request)
        return handle
    return middleware
