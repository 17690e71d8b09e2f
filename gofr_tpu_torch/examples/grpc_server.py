"""gRPC server example (counterpart of ``examples/grpc-server/main.py``):
BERT-base embeddings with dynamic batching on ``/gofr.Embeddings/embed``,
a dynamic JSON unary (no protoc): ``{"token_ids": [...]}`` in (cut or
padded to 64 tokens), ``{"data": {"embedding": [...]}}`` out, the
masked mean of the last layer, at buckets 1, 4, 16 and 32.

``BERT_PRESET`` (default ``base``; ``tiny`` for a 64-wide model) as in
JAX. Where the port differs: every bucket's graph is captured in
``on_startup``, before the server binds; where ``grpcio`` is not
installed the route is not registered, and the app logs so at build.

``build_app(device="cuda")`` runs on the card and raises without CUDA;
``device="cpu"`` runs the plain path. ``params_fn(module, cfg, seed)``
replaces the weight source (default ``module.init(cfg, seed, device)``).
Run it with ``python -m gofr_tpu_torch.examples.grpc_server``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional

import numpy as np

from gofr_tpu_torch import App, new_app, resolve_device
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.grpcx import grpc_available

MAX_LEN = 64
BUCKETS = (1, 4, 16, 32)


async def embed(ctx):
    data = ctx.bind()
    ids = np.zeros((MAX_LEN,), np.int32)
    mask = np.zeros((MAX_LEN,), np.int32)
    tokens = data["token_ids"][:MAX_LEN]
    ids[:len(tokens)] = tokens
    mask[:len(tokens)] = 1
    out = await ctx.predict("bert", (ids, mask))
    return {"embedding": [float(v) for v in out]}


def build_app(device="cuda",
              params_fn: Optional[Callable[[Any, Any, int], Any]] = None
              ) -> App:
    from gofr_tpu_torch.models import bert

    dev = resolve_device(device)
    app = new_app(config_dir("grpc_server"), device=dev)
    cfg = bert.config(os.environ.get("BERT_PRESET", "base"),
                      max_len=MAX_LEN)
    params = params_fn(bert, cfg, 0) if params_fn is not None \
        else bert.init(cfg, 0, device=dev)

    def fn(params, inputs):
        ids, mask = inputs
        return bert.apply(params, cfg, ids, mask)["mean"]

    app.add_model("bert", fn, params=params, buckets=BUCKETS)
    example = (np.zeros((MAX_LEN,), np.int32), np.ones((MAX_LEN,), np.int32))
    app.on_startup(lambda: app.container.tpu.warmup("bert", example))
    if grpc_available():
        app.register_grpc_unary("Embeddings", "embed", embed)
    else:
        app.logger.info("gRPC is off: grpcio is not installed on this "
                        "host, so /gofr.Embeddings/embed is not served")
    return app


if __name__ == "__main__":
    build_app().run()
