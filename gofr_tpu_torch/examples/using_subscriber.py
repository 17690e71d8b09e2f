"""Subscriber example (counterpart of
``examples/using-subscriber/main.py``): batch inference off a topic.
Image payloads (``{"id", "image"}``) come in on ``images``, go through
ResNet-50 at buckets 8, 32 and 64, and ``{"id", "label"}`` goes out on
``labels``; a message's offset is committed once its handler succeeds.

``PUBSUB_BACKEND`` (``KAFKA`` with ``PUBSUB_BROKER``, ``MQTT``,
``GOOGLE`` or ``INMEM``) and ``RESNET_PRESET`` (default ``50``) as in
JAX. Where the port differs: every bucket's graph is captured in
``on_startup``, before the subscriber starts.

``build_app(device="cuda")`` runs on the card and raises without CUDA;
``device="cpu"`` runs the plain path. ``params_fn(module, cfg, seed)``
replaces the weight source (default ``module.init(cfg, seed, device)``).
Run it with ``python -m gofr_tpu_torch.examples.using_subscriber``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np

from gofr_tpu_torch import App, new_app, resolve_device
from gofr_tpu_torch.examples import config_dir

BUCKETS = (8, 32, 64)


async def on_image(ctx):
    payload = ctx.bind()
    # graftcheck: ignore[GT001] — the message's JSON payload is host
    # data, so np.asarray never triggers a device->host sync here
    image = np.asarray(payload["image"], np.float32)
    logits = await ctx.predict("resnet50", image)
    label = int(np.argmax(logits))
    ctx.publish("labels", json.dumps(
        {"id": payload.get("id"), "label": label}).encode())
    ctx.logger.info("classified image %s -> %d", payload.get("id"), label)


def build_app(device="cuda",
              params_fn: Optional[Callable[[Any, Any, int], Any]] = None
              ) -> App:
    from gofr_tpu_torch.models import resnet

    dev = resolve_device(device)
    app = new_app(config_dir("using_subscriber"), device=dev)
    cfg = resnet.config(os.environ.get("RESNET_PRESET", "50"))
    params = params_fn(resnet, cfg, 0) if params_fn is not None \
        else resnet.init(cfg, 0, device=dev)
    app.add_model("resnet50", lambda p, x: resnet.apply(p, cfg, x),
                  params=params, buckets=BUCKETS)
    example = np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
    app.on_startup(lambda: app.container.tpu.warmup("resnet50", example))
    app.subscribe("images", on_image)
    return app


if __name__ == "__main__":
    build_app().run()
