"""Cron example (counterpart of ``examples/using-cron/main.py``): a
heartbeat every minute and a health sweep of the serving datasource every
five, on the app's lifecycle.

Run it with ``python -m gofr_tpu_torch.examples.using_cron``.
"""

from __future__ import annotations

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir


def heartbeat(ctx):
    ctx.logger.info("cron heartbeat", uptime=ctx.container.health()
                    .get("uptime_seconds"))


def tpu_health_sweep(ctx):
    if ctx.tpu is not None:
        ctx.logger.info("tpu health", **ctx.tpu.health_check())


def build_app(device="cuda") -> App:
    app = new_app(config_dir("using_cron"), device=device)
    app.add_cron_job("* * * * *", "heartbeat", heartbeat)
    app.add_cron_job("*/5 * * * *", "tpu-health", tpu_health_sweep)
    return app


app = build_app()

if __name__ == "__main__":
    app.run()
