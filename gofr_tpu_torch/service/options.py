"""Decorator options for the outbound client (the port's copy of
``gofr_tpu/service/options.py``): each ``Option`` wraps a service and
returns the wrapped one; ``new_http_service`` folds a chain of them over
a plain ``HTTPService``. API key, basic auth, default headers, OAuth2
client credentials, and the health endpoint's override."""

from __future__ import annotations

import base64
import json as jsonlib
import threading
import time
import urllib.parse
import urllib.request
from typing import Dict, Optional

from gofr_tpu_torch.service.client import HTTPService, ServiceError


class Option:
    def add_option(self, service: HTTPService) -> HTTPService:
        raise NotImplementedError


class _HeaderInjector(HTTPService):
    """Shared shim: forwards everything, injecting headers per request."""

    def __init__(self, inner: HTTPService):
        self.__dict__.update(inner.__dict__)
        self._inner = inner

    def _extra_headers(self) -> Dict[str, str]:
        return {}

    def request(self, method, path, params=None, body=None, headers=None):
        merged = {**self._extra_headers(), **(headers or {})}
        return self._inner.request(method, path, params=params, body=body,
                                   headers=merged)

    def health_check(self):
        return self._inner.health_check()


class APIKeyConfig(Option):
    """``X-API-KEY`` header on every request."""

    def __init__(self, api_key: str):
        self.api_key = api_key

    def add_option(self, service: HTTPService) -> HTTPService:
        option = self

        class _Service(_HeaderInjector):
            def _extra_headers(self):
                return {"X-API-KEY": option.api_key}

        return _Service(service)


class BasicAuthConfig(Option):
    """``Authorization: Basic`` (user:password, base64)."""

    def __init__(self, username: str, password: str):
        credentials = f"{username}:{password}".encode()
        self._value = "Basic " + base64.b64encode(credentials).decode()

    def add_option(self, service: HTTPService) -> HTTPService:
        option = self

        class _Service(_HeaderInjector):
            def _extra_headers(self):
                return {"Authorization": option._value}

        return _Service(service)


class DefaultHeaders(Option):
    """Static headers on every call."""

    def __init__(self, headers: Dict[str, str]):
        self.headers = dict(headers)

    def add_option(self, service: HTTPService) -> HTTPService:
        option = self

        class _Service(_HeaderInjector):
            def _extra_headers(self):
                return dict(option.headers)

        return _Service(service)


class OAuthConfig(Option):
    """OAuth2 client credentials: fetch a bearer token from
    ``token_url``, cache it until ``early_refresh`` seconds before its
    expiry, refresh on demand."""

    def __init__(self, client_id: str, client_secret: str, token_url: str,
                 scopes: Optional[str] = None, early_refresh: float = 30.0):
        self.client_id = client_id
        self.client_secret = client_secret
        self.token_url = token_url
        self.scopes = scopes
        self.early_refresh = early_refresh
        self._token: Optional[str] = None
        self._expires_at = 0.0
        self._lock = threading.Lock()

    def _fetch(self, service: HTTPService) -> str:
        form = {"grant_type": "client_credentials",
                "client_id": self.client_id,
                "client_secret": self.client_secret}
        if self.scopes:
            form["scope"] = self.scopes
        data = urllib.parse.urlencode(form).encode()
        request = urllib.request.Request(
            self.token_url, data=data, method="POST",
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        with urllib.request.urlopen(request, timeout=10.0) as resp:
            payload = jsonlib.loads(resp.read().decode())
        self._token = payload["access_token"]
        self._expires_at = time.time() + float(
            payload.get("expires_in", 3600))
        return self._token

    def token(self, service: HTTPService) -> str:
        with self._lock:
            if (self._token is None
                    or time.time() > self._expires_at - self.early_refresh):
                try:
                    self._fetch(service)
                except Exception as exc:
                    raise ServiceError(f"oauth token fetch: {exc}") from exc
            return self._token

    def add_option(self, service: HTTPService) -> HTTPService:
        option = self

        class _Service(_HeaderInjector):
            def _extra_headers(self):
                return {"Authorization": f"Bearer {option.token(self)}"}

        return _Service(service)


class HealthConfig(Option):
    """Override the health probe's endpoint."""

    def __init__(self, endpoint: str):
        self.endpoint = endpoint.lstrip("/")

    def add_option(self, service: HTTPService) -> HTTPService:
        service.health_endpoint = self.endpoint
        return service


def new_http_service(base_url: str, logger=None, metrics=None, tracer=None,
                     *options: Option, timeout: float = 30.0,
                     service_name: str = "") -> HTTPService:
    """Build a client and fold the decorator chain over it."""
    service: HTTPService = HTTPService(base_url, logger=logger,
                                      metrics=metrics, tracer=tracer,
                                      timeout=timeout,
                                      service_name=service_name)
    for option in options:
        service = option.add_option(service)
    return service
