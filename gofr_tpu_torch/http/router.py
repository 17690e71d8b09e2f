"""HTTP router (a copy of ``gofr_tpu/http/router.py``): method + path
template matching with ``{param}`` segments, an exact-path fast path,
the middleware chain (first registered = outermost) and static files.
"""

from __future__ import annotations

import asyncio
import mimetypes
import os
from typing import Awaitable, Callable, Dict, List, Optional, Tuple

from gofr_tpu_torch.http.request import Request

# A wire handler: async (Request) -> (status, headers, body-bytes)
WireHandler = Callable[[Request], Awaitable[Tuple[int, Dict[str, str], bytes]]]
Middleware = Callable[[WireHandler], WireHandler]


class _Route:
    __slots__ = ("method", "template", "segments", "handler")

    def __init__(self, method: str, template: str, handler: WireHandler):
        self.method = method.upper()
        self.template = template
        self.segments = [seg for seg in template.strip("/").split("/")] \
            if template.strip("/") else []
        self.handler = handler

    def match(self, parts: List[str]) -> Optional[Dict[str, str]]:
        if len(parts) != len(self.segments):
            return None
        params: Dict[str, str] = {}
        for want, got in zip(self.segments, parts):
            if want.startswith("{") and want.endswith("}"):
                params[want[1:-1]] = got
            elif want != got:
                return None
        return params


class Router:
    def __init__(self):
        self._routes: List[_Route] = []
        self._exact: Dict[Tuple[str, str], _Route] = {}
        self._middleware: List[Middleware] = []
        self._static_dirs: List[Tuple[str, str]] = []  # (url_prefix, fs_dir)

    # -- registration (reference: router.go:26-37 Add) ---------------------
    def add(self, method: str, template: str, handler: WireHandler) -> None:
        route = _Route(method, template, handler)
        self._routes.append(route)
        if not any("{" in seg for seg in route.segments):
            self._exact[(route.method, "/" + "/".join(route.segments))] = route

    def use_middleware(self, *middlewares: Middleware) -> None:
        """Append middlewares; applied outermost-first at dispatch
        (reference: router.go:40-47)."""
        self._middleware.extend(middlewares)

    def add_static_files(self, url_prefix: str, directory: str) -> None:
        """Serve a directory at a URL prefix (reference: router.go
        AddStaticFiles + static handler)."""
        self._static_dirs.append((url_prefix.rstrip("/"), directory))

    @property
    def registered_routes(self) -> List[str]:
        return [f"{route.method} /{'/'.join(route.segments)}"
                for route in self._routes]

    def methods_for(self, path: str) -> List[str]:
        parts = path.strip("/").split("/") if path.strip("/") else []
        return sorted({route.method for route in self._routes
                       if route.match(parts) is not None})

    # -- dispatch -----------------------------------------------------------
    def lookup(self, method: str, path: str) -> Tuple[
            Optional[WireHandler], Dict[str, str], bool, str]:
        """→ (handler, path_params, path_exists_with_other_method,
        matched_route_template). The template (``/users/{id}`` rather than
        ``/users/7``) is what metrics label by — raw paths with embedded
        ids would mint one time series per request."""
        method = method.upper()
        exact = self._exact.get((method, path.rstrip("/") or "/"))
        if exact is not None:
            return exact.handler, {}, False, exact.template
        parts = path.strip("/").split("/") if path.strip("/") else []
        other_method = False
        for route in self._routes:
            params = route.match(parts)
            if params is not None:
                if route.method == method:
                    return route.handler, params, False, route.template
                other_method = True
        static = self._lookup_static(method, path)
        if static is not None:
            handler, prefix = static
            return handler, {}, False, prefix + "/*"
        return None, {}, other_method, ""

    def wrap(self, handler: WireHandler) -> WireHandler:
        """Apply the middleware chain (first registered = outermost)."""
        wrapped = handler
        for middleware in reversed(self._middleware):
            wrapped = middleware(wrapped)
        return wrapped

    def _lookup_static(
            self, method: str,
            path: str) -> Optional[Tuple[WireHandler, str]]:
        if method != "GET":
            return None
        for prefix, directory in self._static_dirs:
            if not path.startswith(prefix + "/") and path != prefix:
                continue
            rel = path[len(prefix):].lstrip("/") or "index.html"
            full = os.path.realpath(os.path.join(directory, rel))
            root = os.path.realpath(directory)
            if not full.startswith(root + os.sep) and full != root:
                return None  # path traversal guard
            if os.path.isfile(full):
                return _make_file_handler(full), prefix
        return None


def _read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _make_file_handler(full_path: str) -> WireHandler:
    async def _serve(_req: Request):
        ctype = mimetypes.guess_type(full_path)[0] or "application/octet-stream"
        # static payloads can be arbitrarily large: read off-loop so a
        # multi-MB asset never stalls in-flight generations
        content = await asyncio.get_running_loop().run_in_executor(
            None, _read_file, full_path)
        return 200, {"Content-Type": ctype}, content
    return _serve
