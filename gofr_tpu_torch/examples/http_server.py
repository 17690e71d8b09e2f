"""HTTP server example (counterpart of ``examples/http-server/main.py``):
``GET /hello``, ``GET /user/{id}``, ``POST /user`` and ResNet-50
``POST /classify``, one image (a nested-list float array, H x W x 3) in,
``{"label", "score"}`` out, concurrent requests coalesced by the app's
dynamic batcher into one graph replay at buckets 1, 4, 16 and 32.

``RESNET_PRESET`` (default ``50``; ``tiny`` for 32 x 32 images) as in
JAX. Where the port differs: every bucket's graph is captured in
``on_startup``, before the server binds, so no request waits behind a
capture (JAX compiles a bucket at its first request).

``build_app(device="cuda")`` runs on the card and raises without CUDA;
``device="cpu"`` runs the plain path. ``params_fn(module, cfg, seed)``
replaces the weight source (default ``module.init(cfg, seed, device)``).
Run it with ``python -m gofr_tpu_torch.examples.http_server``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import numpy as np

from gofr_tpu_torch import App, new_app, resolve_device
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.http.errors import EntityNotFound

BUCKETS = (1, 4, 16, 32)


def hello(ctx):
    name = ctx.param("name") or "World"
    return {"message": f"Hello {name}!"}


def get_user(ctx):
    uid = ctx.path_param("id")
    if uid != "1":
        raise EntityNotFound("id", uid)
    return {"id": 1, "name": "ada"}


def create_user(ctx):
    data = ctx.bind()
    ctx.logger.info("creating user", user=data)
    return data


async def classify(ctx):
    """One image in, one label out, batched with concurrent requests."""
    data = ctx.bind()
    # graftcheck: ignore[GT001] — the request's JSON payload is host
    # data, so np.asarray never triggers a device->host sync here
    image = np.asarray(data["image"], np.float32)
    logits = await ctx.predict("resnet50", image)
    top = int(np.argmax(logits))
    return {"label": top, "score": float(logits[top])}


def build_app(device="cuda",
              params_fn: Optional[Callable[[Any, Any, int], Any]] = None
              ) -> App:
    from gofr_tpu_torch.models import resnet

    dev = resolve_device(device)
    app = new_app(config_dir("http_server"), device=dev)
    app.get("/hello", hello)
    app.get("/user/{id}", get_user)
    app.post("/user", create_user)

    cfg = resnet.config(os.environ.get("RESNET_PRESET", "50"))
    params = params_fn(resnet, cfg, 0) if params_fn is not None \
        else resnet.init(cfg, 0, device=dev)
    app.add_model("resnet50", lambda p, x: resnet.apply(p, cfg, x),
                  params=params, buckets=BUCKETS)
    app.post("/classify", classify)
    example = np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
    app.on_startup(lambda: app.container.tpu.warmup("resnet50", example))
    return app


if __name__ == "__main__":
    build_app().run()
