"""API-key auth middleware
(a copy of ``gofr_tpu/http/middleware/apikey_auth.py``): ``X-API-KEY``
against a key list or a validator; ``/.well-known/`` paths pass.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

from gofr_tpu_torch.http.router import Middleware, WireHandler
from gofr_tpu_torch.http.middleware.basic_auth import _is_well_known


def api_key_auth_middleware(
    keys: Sequence[str] = (),
    validate: Optional[Callable[..., bool]] = None,
    container=None,
) -> Middleware:
    key_set = set(keys)

    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            if _is_well_known(request.path):
                return await next_handler(request)
            key = request.headers.get("x-api-key", "")
            if validate is not None:
                ok = validate(container, key) if container is not None else validate(key)
            else:
                ok = key in key_set
            if not ok:
                body = json.dumps({"error": {"message": "Unauthorized"}}).encode()
                return 401, {"Content-Type": "application/json"}, body
            return await next_handler(request)
        return handle
    return middleware
