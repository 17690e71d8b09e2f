"""HTTP middleware (counterpart of ``gofr_tpu/http/middleware``)."""

from gofr_tpu_torch.http.middleware.apikey_auth import api_key_auth_middleware
from gofr_tpu_torch.http.middleware.basic_auth import basic_auth_middleware
from gofr_tpu_torch.http.middleware.cors import cors_middleware
from gofr_tpu_torch.http.middleware.logger import logging_middleware
from gofr_tpu_torch.http.middleware.metrics import metrics_middleware
from gofr_tpu_torch.http.middleware.oauth import oauth_middleware
from gofr_tpu_torch.http.middleware.tracer import tracing_middleware

__all__ = [
    "api_key_auth_middleware",
    "basic_auth_middleware",
    "cors_middleware",
    "logging_middleware",
    "metrics_middleware",
    "oauth_middleware",
    "tracing_middleware",
]
