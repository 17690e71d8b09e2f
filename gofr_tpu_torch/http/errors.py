"""Typed HTTP errors, each carrying its status code (a copy of
``gofr_tpu/http/errors.py``). Handlers raise (or return) these; the
Responder maps them to wire responses.
"""

from __future__ import annotations

from typing import Sequence


class HTTPError(Exception):
    """Base class: an error with an HTTP status code."""

    status_code = 500

    def __init__(self, message: str = ""):
        super().__init__(message or self.default_message())
        self.message = message or self.default_message()

    def default_message(self) -> str:
        return "internal server error"


class EntityNotFound(HTTPError):
    status_code = 404

    def __init__(self, name: str = "entity", value: str = ""):
        self.name, self.value = name, value
        super().__init__(f"No entity found with {name}: {value}")

    def default_message(self) -> str:
        return "entity not found"


class EntityAlreadyExists(HTTPError):
    status_code = 409

    def default_message(self) -> str:
        return "entity already exists"


class InvalidParam(HTTPError):
    status_code = 400

    def __init__(self, params: Sequence[str] = ()):
        self.params = list(params)
        count = len(self.params)
        super().__init__(
            f"'{count}' invalid parameter(s): {', '.join(self.params)}"
            if count else "invalid parameter"
        )


class MissingParam(HTTPError):
    status_code = 400

    def __init__(self, params: Sequence[str] = ()):
        self.params = list(params)
        count = len(self.params)
        super().__init__(
            f"'{count}' missing parameter(s): {', '.join(self.params)}"
            if count else "missing parameter"
        )


class InvalidRoute(HTTPError):
    status_code = 404

    def default_message(self) -> str:
        return "route not registered"


class MethodNotAllowed(HTTPError):
    status_code = 405

    def default_message(self) -> str:
        return "method not allowed"


class RequestTimeout(HTTPError):
    status_code = 408

    def default_message(self) -> str:
        return "request timed out"


class PanicRecovery(HTTPError):
    """An unhandled exception escaped a handler (the Python analog of the
    reference's panic recovery, errors.go:87-96)."""

    status_code = 500

    def default_message(self) -> str:
        return "some unexpected error has occurred"


class ServiceUnavailable(HTTPError):
    status_code = 503

    def default_message(self) -> str:
        return "service unavailable"
