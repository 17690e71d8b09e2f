"""Circuit breaker for the outbound client (the port's copy of
``gofr_tpu/service/circuit_breaker.py``).

``threshold`` failures in a row (a ``ServiceError`` or a 5xx) open the
circuit: requests fast-fail with ``CircuitOpenError`` for ``interval``
seconds. The first request after that cooldown is a *single-flight
trial* (half-open): it alone reaches the peer while concurrent requests
keep fast-failing. A successful trial closes the circuit; a failed one
reopens it for another full cooldown. Each state transition is counted
in ``app_tpu_circuit_state_total{state}``, so a flapping peer shows as a
transition rate.
"""

from __future__ import annotations

import threading
import time

from gofr_tpu_torch.service.client import HTTPService, ServiceError
from gofr_tpu_torch.service.options import Option

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"


class CircuitOpenError(ServiceError):
    """Fast-fail while the circuit is open (or a half-open trial is
    already in flight)."""


class CircuitBreakerConfig(Option):
    def __init__(self, threshold: int = 5, interval: float = 10.0):
        self.threshold = threshold
        self.interval = interval

    def add_option(self, service: HTTPService) -> HTTPService:
        return _CircuitBreakerService(service, self.threshold, self.interval)


class _CircuitBreakerService(HTTPService):
    def __init__(self, inner: HTTPService, threshold: int, interval: float):
        self.__dict__.update(inner.__dict__)
        self._inner = inner
        self._threshold = threshold
        self._interval = interval
        self._failures = 0
        self._state = STATE_CLOSED
        self._opened_at = 0.0
        self._trial_inflight = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def is_open(self) -> bool:
        """True while requests would fast-fail right now: open and still
        cooling down, or half-open with the trial in flight. An open
        circuit past its cooldown reads as routable again: the next
        request through is the trial."""
        with self._lock:
            if self._state == STATE_OPEN:
                return time.monotonic() - self._opened_at < self._interval
            if self._state == STATE_HALF_OPEN:
                return self._trial_inflight
            return False

    def request(self, method, path, params=None, body=None, headers=None):
        trial = False
        with self._lock:
            if self._state == STATE_OPEN:
                if time.monotonic() - self._opened_at < self._interval:
                    raise CircuitOpenError(
                        f"circuit open for {self.service_name}")
                # cooldown over: this request is the single-flight trial
                self._transition(STATE_HALF_OPEN)
                self._trial_inflight = True
                trial = True
            elif self._state == STATE_HALF_OPEN:
                if self._trial_inflight:
                    raise CircuitOpenError(
                        f"circuit half-open for {self.service_name}: "
                        "trial request already in flight")
                self._trial_inflight = True
                trial = True
        try:
            response = self._inner.request(method, path, params=params,
                                           body=body, headers=headers)
        except ServiceError:
            self._on_failure(trial)
            raise
        if response.status_code >= 500:
            self._on_failure(trial)
        else:
            self._on_success(trial)
        return response

    def _on_failure(self, trial: bool = False) -> None:
        with self._lock:
            if trial or self._state == STATE_HALF_OPEN:
                # the trial failed: back to a full cooldown
                self._trial_inflight = False
                self._opened_at = time.monotonic()
                self._failures = self._threshold
                self._transition(STATE_OPEN)
                return
            self._failures += 1
            if self._failures >= self._threshold \
                    and self._state == STATE_CLOSED:
                self._opened_at = time.monotonic()
                self._transition(STATE_OPEN)

    def _on_success(self, trial: bool) -> None:
        with self._lock:
            self._failures = 0
            if trial or self._state != STATE_CLOSED:
                self._trial_inflight = False
                self._transition(STATE_CLOSED)

    def _transition(self, to: str) -> None:
        """State change under ``self._lock``; logs + transition counter."""
        if to == self._state:
            return
        came_from = self._state
        self._state = to
        if self.logger is not None:
            log = self.logger.warn if to == STATE_OPEN else self.logger.info
            log("circuit %s for %s (was %s, %d failures)",
                to.upper(), self.service_name, came_from, self._failures)
        metrics = getattr(self, "metrics", None)
        if metrics is not None:
            metrics.increment_counter(
                "app_tpu_circuit_state_total", state=to)

    def health_check(self):
        health = self._inner.health_check()
        health.setdefault("details", {})["circuit"] = self.state
        return health

    def close(self) -> None:
        """Nothing to stop: the half-open design has no probe thread."""
