"""Metrics of the port (copies of ``gofr_tpu/metrics``): the windowed
digest and counter the SLO tracker needs, the typed store with its
runtime gauges, the Prometheus exposition, and the slice of the app's
catalog the serving code emits."""

from gofr_tpu_torch.metrics.catalog import (ENGINE_METRICS,
                                            FRAMEWORK_METRICS,
                                            register_engine_metrics,
                                            register_framework_metrics)
from gofr_tpu_torch.metrics.digest import WindowedCounter, WindowedDigest
from gofr_tpu_torch.metrics.exposition import render_prometheus
from gofr_tpu_torch.metrics.manager import (Manager, MetricsError,
                                            current_rss_bytes, new_manager,
                                            system_metrics_refresh)

__all__ = ["ENGINE_METRICS", "FRAMEWORK_METRICS", "Manager", "MetricsError", "WindowedCounter",
           "WindowedDigest", "current_rss_bytes", "new_manager",
           "register_engine_metrics", "register_framework_metrics",
           "render_prometheus",
           "system_metrics_refresh"]
