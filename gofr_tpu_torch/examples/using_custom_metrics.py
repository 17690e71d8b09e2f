"""Custom metrics example (counterpart of
``examples/using-custom-metrics/main.py``): an app registers its own
counter, up-down counter, gauge and histogram and moves them from its
handlers (``POST /transaction``, ``POST /return``); they are served on
the metrics port's ``/metrics`` beside the framework's.

Run it with ``python -m gofr_tpu_torch.examples.using_custom_metrics``.
"""

from __future__ import annotations

import time

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.http.errors import InvalidParam

TRANSACTION_SUCCESS = "transaction_success"
TRANSACTION_TIME = "transaction_time"
TOTAL_CREDIT_DAY_SALES = "total_credit_day_sale"
PRODUCT_STOCK = "product_stock"


async def transaction(ctx):
    start = time.perf_counter()
    data = ctx.bind()
    if "amount" not in data:
        raise InvalidParam(["amount"])
    ctx.metrics.increment_counter(TRANSACTION_SUCCESS)
    ctx.metrics.delta_updown_counter(TOTAL_CREDIT_DAY_SALES,
                                     float(data["amount"]))
    ctx.metrics.set_gauge(PRODUCT_STOCK, float(data.get("stock_left", 0)))
    ctx.metrics.record_histogram(TRANSACTION_TIME,
                                 time.perf_counter() - start)
    return "transaction successful"


async def sale_return(ctx):
    data = ctx.bind()
    ctx.metrics.delta_updown_counter(TOTAL_CREDIT_DAY_SALES,
                                     -float(data.get("amount", 0)))
    return "return successful"


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_custom_metrics"), device=device)
    metrics = app.container.metrics
    metrics.new_counter(TRANSACTION_SUCCESS,
                        "count of successful transactions")
    metrics.new_updown_counter(TOTAL_CREDIT_DAY_SALES,
                               "total credit sales in a day")
    metrics.new_gauge(PRODUCT_STOCK, "products in stock")
    metrics.new_histogram(TRANSACTION_TIME,
                          "time taken by a transaction (s)",
                          (0.005, 0.01, 0.015, 0.02, 0.025, 0.035))
    app.post("/transaction", transaction)
    app.post("/return", sale_return)
    return app


if __name__ == "__main__":
    build_app().run()
