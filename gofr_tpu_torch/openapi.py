"""OpenAPI serving: the spec and the swagger UI (counterpart of
``gofr_tpu/openapi.py``).

``./static/openapi.json`` under the working directory is served at
``/.well-known/openapi.json``, the UI at ``/.well-known/swagger`` and its
assets at ``/.well-known/swagger/{asset}``. The swagger-ui dist
(third-party, Apache-2.0; ``gofr_tpu_torch/static/README.md``) is kept in
the package, so the UI needs no network; a plain renderer of the package's
own serves if those files are missing.
"""

from __future__ import annotations

import asyncio
import json
import os

_STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")
_SWAGGER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>API docs</title>
<link rel="stylesheet" href="swagger/swagger-ui.css">
</head><body>
<div id="swagger-ui"></div>
<script src="swagger/swagger-ui-bundle.js"></script>
<script>
window.ui = SwaggerUIBundle({
  url: 'openapi.json',
  dom_id: '#swagger-ui',
  presets: [SwaggerUIBundle.presets.apis],
  layout: 'BaseLayout',
});
</script></body></html>"""

_UI_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>API docs</title><style>
body{font-family:system-ui,sans-serif;margin:2rem auto;max-width:60rem;
padding:0 1rem;color:#1a1a1a}h1{font-size:1.6rem}
.op{border:1px solid #ddd;border-radius:6px;margin:.7rem 0;padding:.7rem}
.m{display:inline-block;font-weight:700;border-radius:4px;padding:.1rem .5rem;
color:#fff;margin-right:.6rem;font-size:.85rem}
.GET{background:#2f6f44}.POST{background:#9a5b13}.PUT{background:#31589c}
.PATCH{background:#6b4a9c}.DELETE{background:#9c3131}
code{background:#f4f4f4;padding:.1rem .3rem;border-radius:3px}
pre{background:#f7f7f7;padding:.6rem;border-radius:4px;overflow:auto}
.desc{color:#555;margin:.3rem 0 0}</style></head><body>
<h1 id="title">API documentation</h1><p id="version"></p><div id="ops"></div>
<script>
fetch('openapi.json').then(r=>r.json()).then(spec=>{
  document.getElementById('title').textContent=(spec.info&&spec.info.title)||'API';
  document.getElementById('version').textContent=(spec.info&&spec.info.version)||'';
  const ops=document.getElementById('ops');
  for(const [path,methods] of Object.entries(spec.paths||{})){
    for(const [method,op] of Object.entries(methods)){
      const div=document.createElement('div');div.className='op';
      const M=method.toUpperCase();
      div.innerHTML=`<span class="m ${M}">${M}</span><code>${path}</code>`+
        `<p class="desc">${(op&&(op.summary||op.description))||''}</p>`+
        (op&&op.parameters?`<pre>${JSON.stringify(op.parameters,null,2)}</pre>`:'');
      ops.appendChild(div);
    }
  }
});
</script></body></html>"""


_ASSET_TYPES = {"swagger-ui-bundle.js": "application/javascript",
                "swagger-ui.css": "text/css"}
_asset_cache: dict = {}


def _load_assets() -> dict:
    """Read the swagger-ui dist once a process (about 1.6 MB; the files
    do not change while it runs)."""
    if not _asset_cache:
        for name in _ASSET_TYPES:
            path = os.path.join(_STATIC_DIR, name)
            if os.path.isfile(path):
                # graftcheck: ignore[GT001] — one-time startup read
                # (App.start route registration), cached for the process
                # lifetime; never runs per-request
                with open(path, "rb") as handle:
                    _asset_cache[name] = handle.read()
        _asset_cache.setdefault("", b"")  # sentinel: scan happened
    return _asset_cache


def swagger_assets_present() -> bool:
    return all(name in _load_assets() for name in _ASSET_TYPES)


def make_openapi_handlers(spec_path: str):
    """The wire handlers of the ``/.well-known`` routes: (spec, UI,
    asset). The asset handler serves the package's swagger-ui dist under
    ``/.well-known/swagger/<asset>``."""

    def _read_spec() -> bytes:
        with open(spec_path, "rb") as handle:
            body = handle.read()
        json.loads(body)  # refuse to serve a broken spec
        return body

    async def spec_handler(request):
        try:
            # read and parse off the loop: a spec grows with the API, and
            # the loop serves every request
            body = await asyncio.get_running_loop().run_in_executor(
                None, _read_spec)
        except Exception:
            return 500, {"Content-Type": "application/json"}, \
                b'{"error":"openapi.json missing or invalid"}'
        return 200, {"Content-Type": "application/json"}, body

    ui_html = (_SWAGGER_HTML if swagger_assets_present()
               else _UI_HTML).encode()

    async def ui_handler(request):
        return 200, {"Content-Type": "text/html; charset=utf-8"}, ui_html

    async def asset_handler(request):
        name = os.path.basename(request.path_params.get("asset", ""))
        if name in _ASSET_TYPES:
            # the first hit reads the dist off the loop; later hits
            # return the cache
            assets = await asyncio.get_running_loop().run_in_executor(
                None, _load_assets)
            body = assets.get(name)
        else:
            body = None
        if not body:
            return 404, {"Content-Type": "text/plain"}, b"not found"
        return 200, {"Content-Type": _ASSET_TYPES[name],
                     "Cache-Control": "public, max-age=86400"}, body

    return spec_handler, ui_handler, asset_handler
