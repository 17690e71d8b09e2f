"""Example apps on the port, one a JAX example (``examples/<name>/`` with
``-`` written as ``_``), each run as ``python -m
gofr_tpu_torch.examples.<name>``:

- ``llama_generate``: the Llama ``/generate`` microservice;
- ``http_server``: routes, typed errors and ResNet-50 ``/classify``;
- ``grpc_server``: BERT-base embeddings over a dynamic gRPC unary;
- ``using_subscriber``: ResNet-50 batch inference off a topic;
- ``cmd``: the CLI (``new_cmd``), with an offline ``classify``;
- ``websocket_chat``: echo and broadcast through the hub;
- ``http_server_using_redis``, ``using_add_rest_handlers``,
  ``using_migrations``, ``using_file_bind``, ``using_http_service``,
  ``using_publisher``, ``using_custom_metrics``, ``using_cron``: one
  framework surface each.

Each example's configuration is ``configs/<name>/.env`` beside this file,
where the JAX example has a ``configs/.env``; the process environment
wins over it. The model examples' ``build_app(device="cuda")`` runs on
the card and raises without CUDA; ``device="cpu"`` runs the plain path.
"""

import os

__all__ = ["config_dir"]


def config_dir(name: str) -> str:
    """The directory of the example ``name``'s ``.env``."""
    return os.path.join(os.path.dirname(__file__), "configs", name)
