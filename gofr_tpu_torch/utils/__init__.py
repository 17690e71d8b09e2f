"""Utilities: checkpoint and resume for model and optimizer trees
(counterpart of ``gofr_tpu/utils``)."""

from gofr_tpu_torch.utils.checkpoint import (
    checkpoint_metadata,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["checkpoint_metadata", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
