"""Test helpers for user applications (counterpart of
``gofr_tpu/testutil.py``): capture what a function prints, and a
deterministic error for assertions."""

from __future__ import annotations

import contextlib
import io
from typing import Callable


def stdout_output_for_func(func: Callable[[], None]) -> str:
    """Run ``func`` and return everything it printed to stdout."""
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        func()
    return buffer.getvalue()


def stderr_output_for_func(func: Callable[[], None]) -> str:
    """Run ``func`` and return everything it printed to stderr."""
    buffer = io.StringIO()
    with contextlib.redirect_stderr(buffer):
        func()
    return buffer.getvalue()


class CustomError(Exception):
    """Deterministic error for assertions."""

    def __init__(self, message: str = "custom error"):
        super().__init__(message)
        self.message = message
