"""HTTP server backed by Redis (counterpart of
``examples/http-server-using-redis/main.py``): ``POST /redis`` sets every
pair of the JSON body with a five-minute expiry, ``GET /redis/{key}``
reads one key (404 when it is missing), ``GET /redis-pipeline`` runs a
SET and a GET in one batched round trip.

``REDIS_HOST=memory`` (the default in its ``.env``) uses the in-process
engine; a host and ``REDIS_PORT`` use the RESP client. Run it with
``python -m gofr_tpu_torch.examples.http_server_using_redis``.
"""

from __future__ import annotations

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.http.errors import EntityNotFound

REDIS_EXPIRY_SECONDS = 5 * 60


def redis_set(ctx):
    """Set every key/value pair of the JSON body, with the expiry."""
    data = ctx.bind()
    for key, value in data.items():
        ctx.redis.set(key, value, ttl_seconds=REDIS_EXPIRY_SECONDS)
    return "Successful"


def redis_get(ctx):
    key = ctx.path_param("key")
    value = ctx.redis.get(key)
    if value is None:
        raise EntityNotFound("key", key)
    return {key: value}


def redis_pipeline(ctx):
    """Several commands in one round trip: the RESP client writes the
    whole pipeline at once and reads every reply back."""
    set_ok, value = ctx.redis.pipeline([
        ("SET", "testKey1", "testValue1", "PX",
         REDIS_EXPIRY_SECONDS * 1000),
        ("GET", "testKey1"),
    ])
    return {"testKey1": value}


def build_app(device="cuda") -> App:
    app = new_app(config_dir("http_server_using_redis"), device=device)
    app.post("/redis", redis_set)
    app.get("/redis/{key}", redis_get)
    app.get("/redis-pipeline", redis_pipeline)
    return app


if __name__ == "__main__":
    build_app().run()
