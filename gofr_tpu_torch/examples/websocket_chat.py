"""WebSocket example (counterpart of ``examples/websocket-chat/main.py``):
``/chat`` greets each client with ``{"system": "welcome"}``, then
broadcasts every message it reads, as ``{"message": ...}``, to every live
connection through the process's hub.

Run it with ``python -m gofr_tpu_torch.examples.websocket_chat``.
"""

from __future__ import annotations

from gofr_tpu_torch import App, new_app
from gofr_tpu_torch.examples import config_dir
from gofr_tpu_torch.websocket import hub


async def chat(ctx):
    await ctx.write_message({"system": "welcome"})
    while True:
        message = await ctx.read_message()
        await hub().broadcast({"message": message})


def build_app(device="cuda") -> App:
    app = new_app(config_dir("websocket_chat"), device=device)
    app.websocket("/chat", chat)
    return app


app = build_app()

if __name__ == "__main__":
    app.run()
