"""Auth: JWT mint/verify, remote token introspection, HTTP middleware.

Capability parity with the reference's ``app/core/security.py`` (472 LoC —
SURVEY.md §2 component 2): bearer-or-cookie extraction, OAuth token
introspection against a remote endpoint, local JWT validation, a dev-mode mint/
verify path so the whole stack runs without an identity provider
(``security.py:347-421``), and per-user model entitlements carried in the JWT
``scp`` claim (``security.py:17,354``). JWTs are HS256 via stdlib ``hmac``
(PyJWT is not in the image); the introspection client is injectable for tests
(the seam the reference's test implicitly lacked — SURVEY.md §4).

The JWKS and introspection fetches use ``urllib`` in a worker thread, and
the middlewares are written for the port's stdlib server
(``controller/web.py``).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import json
import logging
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Awaitable, Callable

from pydantic import BaseModel, Field

logger = logging.getLogger(__name__)


def _http_fetch(url: str, data: bytes | None = None,
                headers: dict[str, str] | None = None,
                timeout_s: float = 30.0) -> tuple[int, bytes]:
    """One blocking GET (or POST with ``data``): ``(status, body)``; an
    HTTP error status is returned, not raised."""
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class AuthError(Exception):
    def __init__(self, message: str, status: int = 401):
        super().__init__(message)
        self.status = status


class UserJWT(BaseModel):
    """Validated identity attached to each request (reference: ``UserJWT``,
    ``security.py:33-38``)."""

    user_id: str
    email: str = ""
    scopes: list[str] = Field(default_factory=list)  # `scp` claim: entitled models
    is_admin: bool = False
    expires_at: float | None = None

    def entitled_models(self, all_models: list[str]) -> list[str]:
        """Models this user may submit (reference: entitlement check,
        ``app/main.py:412,1323-1341``): empty scp ⇒ everything, else filter."""
        if not self.scopes or self.is_admin:
            return list(all_models)
        return [m for m in all_models if m in self.scopes]


# ---------------------------------------------------------------------------
# Stdlib HS256 JWT
# ---------------------------------------------------------------------------


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def encode_jwt(claims: dict[str, Any], secret: str) -> str:
    """Mint an HS256 JWT (dev path; reference: ``dev_generate_token``,
    ``security.py:347-389``)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def decode_jwt(token: str, secret: str | None = None, verify_exp: bool = True) -> dict[str, Any]:
    """Decode (and optionally verify) a JWT (reference: ``decode_jwt``,
    ``security.py:46-63``)."""
    try:
        header_s, payload_s, sig_s = token.split(".")
    except ValueError as e:
        raise AuthError("malformed token") from e
    if secret is not None:
        expected = hmac.new(
            secret.encode(), f"{header_s}.{payload_s}".encode(), hashlib.sha256
        ).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_s)):
            raise AuthError("invalid token signature")
    try:
        claims = json.loads(_b64url_decode(payload_s))
    except (ValueError, json.JSONDecodeError) as e:
        raise AuthError("malformed token payload") from e
    if verify_exp and "exp" in claims and time.time() > float(claims["exp"]):
        raise AuthError("token expired")
    return claims


def dev_generate_token(
    user_id: str,
    secret: str,
    *,
    scopes: list[str] | None = None,
    is_admin: bool = False,
    email: str = "",
    ttl_s: float = 24 * 3600,
) -> str:
    claims = {
        "sub": user_id,
        "email": email,
        "scp": scopes or [],
        "admin": is_admin,
        "iat": time.time(),
        "exp": time.time() + ttl_s,
    }
    return encode_jwt(claims, secret)


def user_from_claims(claims: dict[str, Any]) -> UserJWT:
    return UserJWT(
        user_id=str(claims.get("sub") or claims.get("user_id") or ""),
        email=str(claims.get("email") or ""),
        scopes=list(claims.get("scp") or []),
        is_admin=bool(claims.get("admin", False)),
        expires_at=claims.get("exp"),
    )


# ---------------------------------------------------------------------------
# RS256 / JWKS validation (reference: security.py:66-189 — python-jose JWKS;
# here via `cryptography`, with the same fetched-key cache)
# ---------------------------------------------------------------------------


def jwt_header(token: str) -> dict[str, Any]:
    try:
        header_s = token.split(".")[0]
        return json.loads(_b64url_decode(header_s))
    except (ValueError, IndexError, json.JSONDecodeError) as e:
        raise AuthError("malformed token") from e


class JWKSClient:
    """Fetches and caches a JWKS document (reference caches fetched keys,
    ``security.py:108-116``). The fetch is injectable for tests."""

    def __init__(
        self,
        url: str,
        *,
        fetch_fn: Callable[[str], Awaitable[dict[str, Any]]] | None = None,
        cache_ttl_s: float = 3600.0,
    ):
        self.url = url
        self._fetch_fn = fetch_fn
        self._cache_ttl_s = cache_ttl_s
        self._keys: dict[str, dict[str, Any]] = {}
        self._fetched_at = 0.0

    async def _fetch(self) -> dict[str, Any]:
        if self._fetch_fn is not None:
            return await self._fetch_fn(self.url)
        status, body = await asyncio.to_thread(_http_fetch, self.url)
        if status != 200:
            raise AuthError(f"JWKS fetch failed ({status})", 503)
        return json.loads(body)

    #: minimum spacing between JWKS fetches — an unknown ``kid`` must not
    #: turn into request-for-request amplification against the IdP
    MIN_REFETCH_S = 30.0

    async def get_key(self, kid: str | None) -> dict[str, Any]:
        now = time.time()
        stale = now - self._fetched_at > self._cache_ttl_s
        missing = kid is not None and kid not in self._keys
        throttled = now - self._fetched_at < self.MIN_REFETCH_S
        if (stale or missing) and not (missing and not stale and throttled):
            doc = await self._fetch()
            self._keys = {k.get("kid", ""): k for k in doc.get("keys", [])}
            self._fetched_at = now
        if kid is None:
            if len(self._keys) == 1:
                return next(iter(self._keys.values()))
            raise AuthError("token has no kid and JWKS has multiple keys")
        key = self._keys.get(kid)
        if key is None:
            raise AuthError(f"unknown signing key {kid!r}")
        return key


def rsa_public_key_from_jwk(jwk: dict[str, Any]):
    """Build an RSA public key from a JWK dict (kty=RSA, base64url n/e)."""
    from cryptography.hazmat.primitives.asymmetric import rsa

    if jwk.get("kty") != "RSA":
        raise AuthError(f"unsupported key type {jwk.get('kty')!r}")
    n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
    e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    return rsa.RSAPublicNumbers(e, n).public_key()


async def decode_jwt_rs256(
    token: str,
    jwks: JWKSClient,
    *,
    verify_exp: bool = True,
    audience: str | None = None,
) -> dict[str, Any]:
    """Verify an RS256 JWT against a JWKS endpoint and return its claims."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = jwt_header(token)
    if header.get("alg") != "RS256":
        raise AuthError(f"unsupported algorithm {header.get('alg')!r}")
    try:
        header_s, payload_s, sig_s = token.split(".")
    except ValueError as e:
        raise AuthError("malformed token") from e
    key = rsa_public_key_from_jwk(await jwks.get_key(header.get("kid")))
    try:
        key.verify(
            _b64url_decode(sig_s),
            f"{header_s}.{payload_s}".encode(),
            padding.PKCS1v15(),
            hashes.SHA256(),
        )
    except InvalidSignature as e:
        raise AuthError("invalid token signature") from e
    try:
        claims = json.loads(_b64url_decode(payload_s))
    except (ValueError, json.JSONDecodeError) as e:
        raise AuthError("malformed token payload") from e
    if verify_exp and "exp" in claims and time.time() > float(claims["exp"]):
        raise AuthError("token expired")
    if audience:
        # enforced only when the deployment configures an audience; RFC 7519
        # allows both string and array `aud`
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud] if aud else []
        if audience not in auds:
            raise AuthError("token audience mismatch")
    return claims


# ---------------------------------------------------------------------------
# Token validation (introspection, JWKS/RS256, or local HS256)
# ---------------------------------------------------------------------------

IntrospectFn = Callable[[str], Awaitable[dict[str, Any]]]


async def dev_mock_token_introspection(token: str) -> dict[str, Any]:
    """Canned introspection for dev/tests (reference:
    ``dev_mock_token_introspection``, ``security.py:412-421``)."""
    if token == "valid_token":
        return {"active": True, "sub": "dev-user", "scp": []}
    return {"active": False}


class TokenValidator:
    """Validates bearer tokens, with a small TTL cache (reference:
    ``TokenValidator``, ``security.py:66-189``).

    Strategies, tried in order:
    1. injected/remote **introspection** (OAuth RFC 7662-style endpoint);
    2. **JWKS/RS256** verification when a JWKS URL is configured and the
       token's header says RS256 (reference: ``security.py:66-189``);
    3. local **HS256 verification** against the configured secret.
    """

    def __init__(
        self,
        *,
        jwt_secret: str,
        introspection_url: str = "",
        introspection_client_id: str = "",
        introspection_client_secret: str = "",
        introspect_fn: IntrospectFn | None = None,
        jwks_url: str = "",
        jwks_client: JWKSClient | None = None,
        audience: str = "",
        cache_ttl_s: float = 60.0,
    ):
        self._jwt_secret = jwt_secret
        self._introspection_url = introspection_url
        self._client_id = introspection_client_id
        self._client_secret = introspection_client_secret
        self._introspect_fn = introspect_fn
        self._jwks = jwks_client or (JWKSClient(jwks_url) if jwks_url else None)
        self._audience = audience
        self._cache: dict[str, tuple[float, UserJWT]] = {}
        self._cache_ttl_s = cache_ttl_s

    async def _remote_introspect(self, token: str) -> dict[str, Any]:
        # RFC 7662 endpoints typically require client auth (the reference
        # sends OpenBridge client creds, app/core/security.py:118-130)
        headers = {"Content-Type": "application/x-www-form-urlencoded"}
        if self._client_id:
            creds = f"{self._client_id}:{self._client_secret}".encode()
            headers["Authorization"] = "Basic " + base64.b64encode(creds).decode()
        status, body = await asyncio.to_thread(
            _http_fetch, self._introspection_url,
            urllib.parse.urlencode({"token": token}).encode(), headers,
        )
        if status != 200:
            raise AuthError(f"introspection failed ({status})", 401)
        return json.loads(body)

    async def validate(self, token: str) -> UserJWT:
        now = time.time()
        cached = self._cache.get(token)
        if cached and cached[0] > now:
            return cached[1]

        user: UserJWT | None = None
        if self._introspect_fn is not None or self._introspection_url:
            fn = self._introspect_fn or self._remote_introspect
            data = await fn(token)
            if not data.get("active", False):
                raise AuthError("token not active")
            user = user_from_claims(data)
        elif self._jwks is not None and jwt_header(token).get("alg") == "RS256":
            claims = await decode_jwt_rs256(
                token, self._jwks, audience=self._audience or None
            )
            user = user_from_claims(claims)
        else:
            if not self._jwt_secret:
                # no HS256 secret configured (e.g. JWKS-only deployment with
                # the default secret neutralised): a non-RS256 token has no
                # valid verification path — never fall back to a known secret
                raise AuthError("no local token verification configured")
            claims = decode_jwt(token, self._jwt_secret)
            user = user_from_claims(claims)
        if not user.user_id:
            raise AuthError("token has no subject")
        ttl = self._cache_ttl_s
        if user.expires_at is not None:
            ttl = min(ttl, max(user.expires_at - now, 0.0))
        self._cache[token] = (now + ttl, user)
        if len(self._cache) > 10_000:  # bound the cache
            self._cache = {k: v for k, v in self._cache.items() if v[0] > now}
        return user


# ---------------------------------------------------------------------------
# HTTP middleware
# ---------------------------------------------------------------------------


def extract_bearer(request: Any) -> str | None:
    """Authorization header or auth cookie (reference cookie-or-bearer
    extraction, ``security.py:211-240``)."""
    auth = request.headers.get("Authorization", "")
    if auth.lower().startswith("bearer "):
        return auth[7:].strip()
    cookie = request.cookies.get("ftc_token")
    return cookie or None


def build_cors_middleware(origins: list[str]):
    """CORS for browser frontends (reference: CORSMiddleware from
    ``settings.cors_origins``, ``app/api/middleware.py:59-66``). Handles the
    OPTIONS preflight and stamps Access-Control headers on every response
    whose Origin is allowed ("*" allows any)."""
    from . import web

    allow_any = "*" in origins
    allowed = set(origins)

    def _origin_ok(origin: str) -> bool:
        return bool(origin) and (allow_any or origin in allowed)

    def _stamp(resp, origin: str):
        resp.headers["Access-Control-Allow-Origin"] = "*" if allow_any else origin
        resp.headers["Vary"] = "Origin"
        return resp

    @web.middleware
    async def cors_middleware(request, handler):
        origin = request.headers.get("Origin", "")
        if request.method == "OPTIONS" and "Access-Control-Request-Method" in request.headers:
            if not _origin_ok(origin):
                return web.Response(status=403)
            resp = web.Response(status=204)
            resp.headers["Access-Control-Allow-Methods"] = (
                "GET, POST, PUT, DELETE, OPTIONS"
            )
            resp.headers["Access-Control-Allow-Headers"] = (
                request.headers.get("Access-Control-Request-Headers")
                or "Authorization, Content-Type"
            )
            resp.headers["Access-Control-Max-Age"] = "600"
            return _stamp(resp, origin)
        resp = await handler(request)
        if _origin_ok(origin):
            _stamp(resp, origin)
        return resp

    return cors_middleware


def build_auth_middleware(
    validator: TokenValidator,
    *,
    enabled: bool,
    api_prefix: str = "/api/v1",
    dev_user: str = "dev-user",
):
    """Middleware guarding ``/api/v1/*`` (reference:
    ``OpenBridgeBasicMiddleware``, ``security.py:201-268``). With auth disabled
    (local env) every request is attributed to ``dev_user`` — the reference's
    local-env fallback (``security.py:242-248``)."""
    from . import web

    @web.middleware
    async def auth_middleware(request, handler):
        if (
            not request.path.startswith(api_prefix)
            or request.path.endswith("/health")
            # token mint must be reachable without a token; the handler
            # itself refuses in production
            or request.path.endswith("/auth/dev-token")
        ):
            return await handler(request)
        if not enabled:
            request["user"] = UserJWT(user_id=dev_user, is_admin=True)
            return await handler(request)
        token = extract_bearer(request)
        if not token:
            return web.json_response({"detail": "missing bearer token"}, status=401)
        try:
            request["user"] = await validator.validate(token)
        except AuthError as e:
            return web.json_response({"detail": str(e)}, status=e.status)
        return await handler(request)

    return auth_middleware
