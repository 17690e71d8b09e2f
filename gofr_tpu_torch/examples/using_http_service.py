"""Outbound HTTP service example (counterpart of
``examples/using-http-service/main.py``): two named downstream services
over ``FACTS_URL`` — ``cat-facts`` with a circuit breaker (four failures
open it, a probe a second closes it) and the health endpoint ``breeds``,
and ``fact-checker`` with a wrong health endpoint, so
``/.well-known/health`` shows a degraded dependency. ``GET /fact``
proxies through ``cat-facts``.

    FACTS_URL=http://localhost:9000 python -m gofr_tpu_torch.examples.using_http_service
"""

from __future__ import annotations

import os

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.service import CircuitBreakerConfig, HealthConfig


def fact(ctx):
    # a plain def runs in a worker thread, so the blocking outbound call
    # never stalls the event loop
    service = ctx.get_http_service("cat-facts")
    response = service.get("/fact")
    data = response.json()
    if isinstance(data, dict) and "data" in data:
        data = data["data"]   # a gofr-style envelope
    ctx.logger.info("fetched fact of length %s", data.get("length"))
    return {"fact": data.get("fact"), "length": data.get("length")}


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_http_service"), device=device)
    base = os.environ.get("FACTS_URL", "https://catfact.ninja")
    app.add_http_service("cat-facts", base,
                         CircuitBreakerConfig(threshold=4, interval=1.0),
                         HealthConfig("breeds"))
    app.add_http_service("fact-checker", base, HealthConfig("breed"))
    app.get("/fact", fact)
    return app


if __name__ == "__main__":
    build_app().run()
