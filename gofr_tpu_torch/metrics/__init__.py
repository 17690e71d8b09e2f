"""Metrics of the port (copies of ``gofr_tpu/metrics``): the windowed
digest and counter the SLO tracker needs, the typed store, and the
slice of the app's catalog the serving code emits."""

from gofr_tpu_torch.metrics.catalog import (ENGINE_METRICS,
                                            register_engine_metrics)
from gofr_tpu_torch.metrics.digest import WindowedCounter, WindowedDigest
from gofr_tpu_torch.metrics.manager import Manager, MetricsError, new_manager

__all__ = ["ENGINE_METRICS", "Manager", "MetricsError", "WindowedCounter",
           "WindowedDigest", "new_manager", "register_engine_metrics"]
