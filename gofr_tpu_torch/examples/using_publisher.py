"""Publisher example (counterpart of ``examples/using-publisher/main.py``):
``POST /publish-order`` (``orderId``, ``status``) and ``POST
/publish-product`` (``productId``, ``price``) publish the bound JSON body
to ``order-logs`` and ``products`` through the configured backend
(``PUBSUB_BACKEND``: ``KAFKA``, ``MQTT``, ``GOOGLE``, or ``INMEM`` as in
its ``.env``); a missing field is a 400.

Run it with ``python -m gofr_tpu_torch.examples.using_publisher``.
"""

from __future__ import annotations

import json

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.http.errors import InvalidParam


def _publish(ctx, topic, required_fields):
    data = ctx.bind()
    missing = [f for f in required_fields if f not in data]
    if missing:
        raise InvalidParam(missing)
    ctx.publish(topic, json.dumps(data).encode())
    return "Published"


async def order(ctx):
    return _publish(ctx, "order-logs", ("orderId", "status"))


async def product(ctx):
    return _publish(ctx, "products", ("productId", "price"))


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_publisher"), device=device)
    app.post("/publish-order", order)
    app.post("/publish-product", product)
    return app


if __name__ == "__main__":
    build_app().run()
