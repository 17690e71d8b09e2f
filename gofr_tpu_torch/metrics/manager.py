"""Metrics manager: typed metric store (a copy of
``gofr_tpu/metrics/manager.py``: ``Manager``, ``MetricsError``,
``new_manager``, and the runtime gauges a scrape refreshes,
``current_rss_bytes`` and ``system_metrics_refresh``).

The engine, the SLO tracker, the watchdog, the brownout ladder and the
fault plane call only ``increment_counter``, ``delta_updown_counter``,
``set_gauge`` and ``record_histogram`` on whatever ``metrics`` they are
given, so the JAX package's ``Manager`` plugs in as well as this one;
the port keeps its own for the tests and ``chip_smoke.py``. The logger is
duck-typed (anything with ``error``). Using an unregistered or
wrong-typed name logs an error through it instead of raising, as in the
JAX package: a caller that must not lose a metric gives a logger whose
``error`` raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

_CARDINALITY_WARN = 100


class MetricsError(Exception):
    pass


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    def __init__(self, name: str, kind: str, desc: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind  # counter | updown | histogram | gauge
        self.desc = desc
        self.buckets = list(buckets) if buckets else []
        # series: labelkey -> value (float) or histogram state dict
        self.series: Dict[LabelKey, object] = {}


class Manager:
    """Create-then-use metrics API (reference: metrics/register.go:15-25).

    Metrics must be registered (``new_counter`` etc.) before use; using an
    unregistered or wrong-typed name logs an error instead of raising, so a
    metrics bug never takes down a request path (matching the reference's
    error-log-and-continue behaviour, metrics/metrics.go).
    """

    def __init__(self, logger: Any = None):
        self._logger = logger
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    # -- registration -------------------------------------------------------
    def _register(self, name: str, kind: str, desc: str,
                  buckets: Optional[Sequence[float]] = None) -> None:
        with self._lock:
            if name in self._metrics:
                self._err(f"metric {name!r} already registered")
                return
            self._metrics[name] = _Metric(name, kind, desc, buckets)

    def new_counter(self, name: str, desc: str = "") -> None:
        self._register(name, "counter", desc)

    def new_updown_counter(self, name: str, desc: str = "") -> None:
        self._register(name, "updown", desc)

    def new_histogram(self, name: str, desc: str = "",
                      buckets: Sequence[float] = ()) -> None:
        if not buckets:
            buckets = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10, 30)
        self._register(name, "histogram", desc, buckets)

    def new_gauge(self, name: str, desc: str = "") -> None:
        self._register(name, "gauge", desc)

    # -- writes -------------------------------------------------------------
    def _get(self, name: str, kind: str) -> Optional[_Metric]:
        metric = self._metrics.get(name)
        if metric is None:
            self._err(f"metric {name!r} not registered")
            return None
        if metric.kind != kind:
            self._err(f"metric {name!r} is a {metric.kind}, not a {kind}")
            return None
        return metric

    def increment_counter(self, name: str, /, **labels: str) -> None:
        metric = self._get(name, "counter")
        if metric is None:
            return
        key = _label_key(labels)
        with self._lock:
            self._check_cardinality(metric)
            metric.series[key] = float(metric.series.get(key, 0.0)) + 1.0  # type: ignore[arg-type]

    def delta_updown_counter(self, name: str, value: float, /, **labels: str) -> None:
        metric = self._get(name, "updown")
        if metric is None:
            return
        key = _label_key(labels)
        with self._lock:
            self._check_cardinality(metric)
            metric.series[key] = float(metric.series.get(key, 0.0)) + value  # type: ignore[arg-type]

    def record_histogram(self, name: str, value: float, /,
                         exemplar: Optional[Dict[str, str]] = None,
                         **labels: str) -> None:
        """Record one observation. ``exemplar`` is an optional small label
        dict (typically ``{"trace_id": ...}``) attached to the bucket the
        value falls into and rendered as an OpenMetrics exemplar — the
        bridge from an aggregate latency histogram back to one concrete
        traced request."""
        metric = self._get(name, "histogram")
        if metric is None:
            return
        key = _label_key(labels)
        with self._lock:
            self._check_cardinality(metric)
            state = metric.series.get(key)
            if state is None:
                state = {"count": 0, "sum": 0.0,
                         "buckets": [0] * len(metric.buckets),
                         "exemplars": {}}
                metric.series[key] = state
            state["count"] += 1          # type: ignore[index]
            state["sum"] += value        # type: ignore[index]
            # per-bucket counts; exposition cumulates (prometheus `le` form)
            bucket_idx = len(metric.buckets)   # +Inf bucket
            for i, bound in enumerate(metric.buckets):
                if value <= bound:
                    state["buckets"][i] += 1  # type: ignore[index]
                    bucket_idx = i
                    break
            if exemplar:
                # last observation wins per bucket (OpenMetrics allows at
                # most one exemplar per bucket line)
                state.setdefault("exemplars", {})[bucket_idx] = (  # type: ignore[union-attr]
                    {str(k): str(v) for k, v in exemplar.items()},
                    float(value), time.time())

    def set_gauge(self, name: str, value: float, /, **labels: str) -> None:
        metric = self._get(name, "gauge")
        if metric is None:
            return
        key = _label_key(labels)
        with self._lock:
            self._check_cardinality(metric)
            metric.series[key] = float(value)

    # -- reads (for exposition and tests) -----------------------------------
    def snapshot(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def value(self, name: str, /, **labels: str) -> Optional[float]:
        metric = self._metrics.get(name)
        if metric is None:
            return None
        state = metric.series.get(_label_key(labels))
        if isinstance(state, dict):
            return float(state["count"])
        return float(state) if state is not None else None

    # -- internals ----------------------------------------------------------
    def _check_cardinality(self, metric: _Metric) -> None:
        if len(metric.series) == _CARDINALITY_WARN:
            self._err(
                f"metric {metric.name!r} exceeded {_CARDINALITY_WARN} label "
                "combinations; high-cardinality labels degrade scrapes"
            )

    def _err(self, message: str) -> None:
        if self._logger is not None:
            self._logger.error(message)


def new_manager(logger: Any = None) -> Manager:
    return Manager(logger=logger)



def current_rss_bytes() -> Optional[float]:
    """Current (not peak) resident set size from ``/proc/self/statm``;
    None where procfs is unavailable."""
    import os
    try:
        with open("/proc/self/statm") as fh:
            resident_pages = int(fh.read().split()[1])
        return float(resident_pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, IndexError, ValueError):
        return None


def system_metrics_refresh(manager: Manager, app_name: str,
                           app_version: str) -> None:
    """Refresh the runtime gauges; the app calls it on each scrape."""
    import gc
    import resource

    manager.set_gauge("app_info", 1.0, name=app_name, version=app_version)
    manager.set_gauge("threads_total", float(threading.active_count()))
    # ru_maxrss is the peak: a gauge built from it never goes down
    rss = current_rss_bytes()
    if rss is None:
        rss = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) \
            * 1024.0
    manager.set_gauge("memory_rss_bytes", rss)
    manager.set_gauge("gc_objects", float(gc.get_count()[0]))
    manager.set_gauge("uptime_seconds", time.monotonic() - _START)


_START = time.monotonic()
