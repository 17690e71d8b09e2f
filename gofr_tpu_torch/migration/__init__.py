"""Migrations (counterpart of ``gofr_tpu/migration``)."""

from gofr_tpu_torch.migration.runner import (
    Datasources,
    Migration,
    MigrationError,
    last_migration,
    run_migrations,
)

__all__ = ["Datasources", "Migration", "MigrationError", "last_migration",
           "run_migrations"]
