"""OAuth2 / JWT bearer-token middleware
(a copy of ``gofr_tpu/http/middleware/oauth.py``): HS256 through
``hmac``, RS256 through ``cryptography`` where it is installed, keys
from a JWKS document refreshed on an interval; the claims go into the
request's context values.
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import threading
import time
import urllib.request
from typing import Dict, Optional

from gofr_tpu_torch.http.router import Middleware, WireHandler
from gofr_tpu_torch.http.middleware.basic_auth import _is_well_known


def _b64url_decode(data: str) -> bytes:
    padding = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + padding)


def _unauthorized(message: str = "Unauthorized"):
    body = json.dumps({"error": {"message": message}}).encode()
    return 401, {"Content-Type": "application/json"}, body


class JWKSKeychain:
    """Fetches and caches a JWKS document, refreshed on an interval
    (oauth.go:53-71)."""

    def __init__(self, url: str, refresh_interval: float = 300.0):
        self.url = url
        self.refresh_interval = refresh_interval
        self._keys: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._last_fetch = 0.0

    def key(self, kid: str) -> Optional[dict]:
        with self._lock:
            now = time.monotonic()
            if now - self._last_fetch > self.refresh_interval or kid not in self._keys:
                self._refresh()
                self._last_fetch = now
            return self._keys.get(kid)

    def _refresh(self) -> None:
        try:
            with urllib.request.urlopen(self.url, timeout=5) as resp:
                doc = json.loads(resp.read())
            self._keys = {k.get("kid", ""): k for k in doc.get("keys", [])}
        except Exception:
            pass  # keep stale keys on fetch failure


def _verify_rs256(signing_input: bytes, signature: bytes, jwk: dict) -> bool:
    try:
        from cryptography.hazmat.primitives.asymmetric import rsa, padding
        from cryptography.hazmat.primitives import hashes
    except ImportError:
        return False
    try:
        n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
        e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
        public_key = rsa.RSAPublicNumbers(e, n).public_key()
        public_key.verify(signature, signing_input,
                          padding.PKCS1v15(), hashes.SHA256())
        return True
    except Exception:
        return False


def decode_jwt(token: str, secret: Optional[str] = None,
               keychain: Optional[JWKSKeychain] = None) -> Optional[dict]:
    """Verify + decode a JWT. Returns claims dict or None."""
    parts = token.split(".")
    if len(parts) != 3:
        return None
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
        signature = _b64url_decode(parts[2])
    except Exception:
        return None
    signing_input = f"{parts[0]}.{parts[1]}".encode()
    alg = header.get("alg", "")
    if alg == "HS256":
        if secret is None:
            return None
        expected = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, signature):
            return None
    elif alg == "RS256":
        if keychain is None:
            return None
        jwk = keychain.key(header.get("kid", ""))
        if jwk is None or not _verify_rs256(signing_input, signature, jwk):
            return None
    else:
        return None
    try:
        exp = claims.get("exp")
        if exp is not None and time.time() > float(exp):
            return None
        nbf = claims.get("nbf")
        if nbf is not None and time.time() < float(nbf):
            return None
    except (TypeError, ValueError):      # non-numeric exp/nbf → reject
        return None
    return claims


def oauth_middleware(jwks_url: Optional[str] = None,
                     secret: Optional[str] = None,
                     refresh_interval: float = 300.0) -> Middleware:
    keychain = JWKSKeychain(jwks_url, refresh_interval) if jwks_url else None

    def middleware(next_handler: WireHandler) -> WireHandler:
        async def handle(request):
            if _is_well_known(request.path):
                return await next_handler(request)
            header = request.headers.get("authorization", "")
            if not header.startswith("Bearer "):
                return _unauthorized("missing bearer token")
            claims = decode_jwt(header[7:], secret=secret, keychain=keychain)
            if claims is None:
                return _unauthorized("invalid token")
            request.context_values["jwt_claims"] = claims
            return await next_handler(request)
        return handle
    return middleware
