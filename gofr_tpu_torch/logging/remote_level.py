"""Remote log level (a copy of ``gofr_tpu/logging/remote_level.py``):
poll ``REMOTE_LOG_URL`` every ``REMOTE_LOG_FETCH_INTERVAL`` seconds and
apply the level it returns to the running logger. The document is
``{"data": [{"serviceLevel": {"logLevel": "DEBUG"}}]}`` or
``{"level": "DEBUG"}``.
"""

from __future__ import annotations

import json
import threading
import urllib.request

from gofr_tpu_torch.logging.logger import Level, Logger


def _extract_level(doc) -> str:
    if isinstance(doc, dict):
        if "level" in doc:
            return str(doc["level"])
        data = doc.get("data")
        if isinstance(data, list) and data:
            service_level = data[0].get("serviceLevel", {})
            return str(service_level.get("logLevel", ""))
    return ""


def start_remote_level_poller(logger: Logger, url: str,
                              interval: float = 15.0) -> threading.Thread:
    """Returns the poller thread; call ``thread.stop()`` to end the loop
    (tests / graceful shutdown — in a server it runs for the process
    lifetime as a daemon, like the reference's goroutine)."""
    stop = threading.Event()

    def poll_loop() -> None:
        while True:
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    doc = json.loads(resp.read())
                name = _extract_level(doc)
                if name:
                    new_level = Level.parse(name, logger.level)
                    if new_level != logger.level:
                        logger.info("remote log level change: %s -> %s",
                                    logger.level.name, new_level.name)
                        logger.change_level(new_level)
            except Exception:
                pass
            if stop.wait(interval):
                return

    thread = threading.Thread(target=poll_loop, name="remote-log-level",
                              daemon=True)
    thread.stop = stop.set  # type: ignore[attr-defined]
    thread.start()
    return thread
