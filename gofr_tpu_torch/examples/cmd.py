"""CLI example (counterpart of ``examples/cmd/main.py``): sub-commands
with flags, and ``classify``, which runs the executor offline from a CLI
context (``ctx.predict`` calls it directly; no server loop).

    python -m gofr_tpu_torch.examples.cmd hello -name=you
    python -m gofr_tpu_torch.examples.cmd classify
    python -m gofr_tpu_torch.examples.cmd -h

``CMD_LOGS_FILE`` sends the logs to a file, so stdout holds the
commands' output alone. ``classify`` builds a tiny ResNet on the app's
device: on the card its one bucket's graph is captured at the first
call; without CUDA it raises, and ``build_app(device="cpu")`` runs it on
the CPU. Where the port differs: the process exits with the command's
code (2 for an unknown command, 1 for one that raised), where JAX's
exits 0 (ROADMAP §3).
"""

from __future__ import annotations

import sys

from gofr_tpu_torch import App, new_cmd
from gofr_tpu_torch.examples import config_dir


def hello(ctx):
    return f"Hello {ctx.param('name') or 'World'}!"


def classify(ctx):
    import asyncio

    import numpy as np

    from gofr_tpu_torch.models import resnet
    from gofr_tpu_torch.tpu import Executor

    device = ctx.container.device
    cfg = resnet.config("tiny")
    params = resnet.init(cfg, 0, device=device)
    executor = Executor(ctx.logger, ctx.metrics, device=device)
    executor.register("resnet", lambda p, x: resnet.apply(p, cfg, x),
                      params, buckets=(1,))
    ctx.container.tpu = executor
    image = np.random.default_rng(0).standard_normal(
        (cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    logits = asyncio.run(ctx.predict("resnet", image))
    return {"label": int(logits.argmax())}


def build_app(device="cuda") -> App:
    app = new_cmd(config_dir("cmd"), device=device)
    app.sub_command("hello", hello, description="greet",
                    help_text="hello -name=you")
    app.sub_command("classify", classify,
                    description="classify a random image offline")
    return app


app = build_app()

if __name__ == "__main__":
    sys.exit(app.run() or 0)
