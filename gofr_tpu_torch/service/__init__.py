"""Outbound HTTP client with decorator options: auth, default headers,
circuit breaker, health override (counterpart of ``gofr_tpu/service``)."""

from gofr_tpu_torch.service.circuit_breaker import (
    CircuitBreakerConfig,
    CircuitOpenError,
)
from gofr_tpu_torch.service.client import (
    HTTPService,
    ServiceError,
    ServiceResponse,
)
from gofr_tpu_torch.service.options import (
    APIKeyConfig,
    BasicAuthConfig,
    DefaultHeaders,
    HealthConfig,
    OAuthConfig,
    Option,
    new_http_service,
)

__all__ = [
    "APIKeyConfig", "BasicAuthConfig", "CircuitBreakerConfig",
    "CircuitOpenError", "DefaultHeaders", "HealthConfig", "HTTPService",
    "OAuthConfig", "Option", "ServiceError", "ServiceResponse",
    "new_http_service",
]
