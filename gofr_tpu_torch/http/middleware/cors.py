"""CORS middleware (a copy of
``gofr_tpu/http/middleware/cors.py``): ``*`` origin and the route table's
methods on a preflight, ``ACCESS_CONTROL_*`` overrides from config.
"""

from __future__ import annotations

from typing import Dict

from gofr_tpu_torch.config import Config
from gofr_tpu_torch.http.router import Middleware, Router, WireHandler

_OVERRIDABLE = {
    "ACCESS_CONTROL_ALLOW_ORIGIN": "Access-Control-Allow-Origin",
    "ACCESS_CONTROL_ALLOW_HEADERS": "Access-Control-Allow-Headers",
    "ACCESS_CONTROL_ALLOW_CREDENTIALS": "Access-Control-Allow-Credentials",
    "ACCESS_CONTROL_EXPOSE_HEADERS": "Access-Control-Expose-Headers",
    "ACCESS_CONTROL_MAX_AGE": "Access-Control-Max-Age",
}


def cors_middleware(config: Config, router: Router) -> Middleware:
    base_headers: Dict[str, str] = {
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Headers":
            "Authorization, Content-Type, x-requested-with, origin, true-client-ip, X-Correlation-ID",
    }
    for env_key, header in _OVERRIDABLE.items():
        value = config.get(env_key)
        if value:
            base_headers[header] = value

    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            if request.method == "OPTIONS":
                methods = router.methods_for(request.path)
                allow = ", ".join(methods + ["OPTIONS"]) if methods else "OPTIONS"
                headers = dict(base_headers)
                headers["Access-Control-Allow-Methods"] = allow
                return 200, headers, b""
            status, headers, body = await next_handler(request)
            for name, value in base_headers.items():
                headers.setdefault(name, value)
            return status, headers, body
        return handle
    return middleware
