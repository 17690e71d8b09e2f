"""The HTTP transport (counterpart of ``gofr_tpu/http``): errors, the
request, responses, the responder, the router, the server and its
middleware."""

from gofr_tpu_torch.http.errors import (
    EntityAlreadyExists,
    EntityNotFound,
    HTTPError,
    InvalidParam,
    InvalidRoute,
    MissingParam,
    PanicRecovery,
    RequestTimeout,
)
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.responder import Responder
from gofr_tpu_torch.http.response import (FileResponse, Raw, Redirect,
                                          Response, Stream)
from gofr_tpu_torch.http.router import Router

__all__ = [
    "EntityAlreadyExists",
    "EntityNotFound",
    "HTTPError",
    "InvalidParam",
    "InvalidRoute",
    "MissingParam",
    "PanicRecovery",
    "RequestTimeout",
    "Request",
    "Responder",
    "Response",
    "Raw",
    "FileResponse",
    "Redirect",
    "Stream",
    "Router",
]
