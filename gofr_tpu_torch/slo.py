"""Request deadlines (the deadline part of ``gofr_tpu/slo.py``, a copy of
its code with a contextvar of the port's own).

A request may carry an ``X-Request-Deadline-Ms`` header (milliseconds of
budget from ingress). The handler converts it to an absolute monotonic
instant with :func:`set_request_deadline`, which stashes it in a
contextvar; the contextvar survives into async handlers and
``asyncio.to_thread``, so the generation engine reads it at submit time
(:func:`current_deadline`) without a parameter in user code. The engine
derives the request's admission class from it (``tpu/sched.deadline_class``)
and sheds a request whose deadline passed while it waited in the queue,
before its prefill, with :class:`DeadlineExceeded`.

The JAX package's app sets *its* contextvar (``gofr_tpu.slo``); the port
reads only this one, so an app that serves the torch engine sets this
one too.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

__all__ = ["DeadlineExceeded", "set_request_deadline", "current_deadline",
           "parse_deadline_header"]


class DeadlineExceeded(Exception):
    """Raised to the caller when a request is shed because its deadline
    had already passed before any device work started. The HTTP
    responder duck-types ``status_code``, mapping this to 503 without the
    engine importing HTTP code."""

    status_code = 503

    def __init__(self,
                 message: str = "request deadline exceeded before execution"):
        super().__init__(message)


_deadline: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "gofr_tpu_torch_deadline", default=None)


def set_request_deadline(budget_ms: Optional[float],
                         now: Optional[float] = None) -> Optional[float]:
    """Convert a relative millisecond budget into an absolute monotonic
    deadline and make it current. Returns the absolute deadline (or None
    for no/invalid budget)."""
    if budget_ms is None or budget_ms <= 0:
        _deadline.set(None)
        return None
    now = time.monotonic() if now is None else now
    deadline = now + budget_ms / 1000.0
    _deadline.set(deadline)
    return deadline


def current_deadline() -> Optional[float]:
    """Absolute monotonic deadline of the current request, or None."""
    return _deadline.get()


def parse_deadline_header(raw: str) -> Optional[float]:
    """``X-Request-Deadline-Ms`` value -> float ms, None when absent or
    malformed (a bad header must never fail the request)."""
    if not raw:
        return None
    try:
        budget = float(raw)
    except (TypeError, ValueError):
        return None
    return budget if budget > 0 else None
