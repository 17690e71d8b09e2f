"""Logging (counterpart of ``gofr_tpu/logging``); the remote level
poller is ``gofr_tpu_torch.logging.remote_level``."""

from gofr_tpu_torch.logging.logger import (
    Level,
    Logger,
    new_file_logger,
    new_logger,
    new_silent_logger,
)

__all__ = ["Level", "Logger", "new_file_logger", "new_logger",
           "new_silent_logger"]
