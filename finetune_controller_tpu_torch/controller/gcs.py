"""GCS object store — the cloud backend behind the ``ObjectStore`` seam.

The port's copy of the reference module, on the port's stdlib HTTP client
(``controller/httpclient.py``) in the place of ``aiohttp``; the
service-account JWT is built by :func:`service_account_assertion`, the
reference's inline code as a function of its own.

The reference moves real bytes through S3 with aioboto3 plus ``aws-cli``
init/sidecar containers (``app/utils/S3Handler.py:12,25``,
``PyTorchJobDeployer.py:74,142``). The TPU build's natural bucket store is
GCS (it is what GKE TPU node pools authenticate to out of the box), talked to
directly over HTTP against the JSON API — no SDK dependency, and the
endpoint is injectable so tests run against an in-process fake (SURVEY.md §4
test strategy; the reference could not test its S3 path at all).

Auth is a pluggable async token provider. The default chain:

1. ``GOOGLE_OAUTH_ACCESS_TOKEN`` env var (dev / CI);
2. service-account JSON at ``GOOGLE_APPLICATION_CREDENTIALS`` — a self-signed
   RS256 JWT exchanged at the token URI (no gcloud needed);
3. the GCE/GKE metadata server (workload identity — the in-cluster path).

URIs stay in the framework's ``obj://bucket/key`` convention; the bucket maps
1:1 onto a GCS bucket.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import os
import time
import urllib.parse
from pathlib import Path
from typing import Any, AsyncIterator, Awaitable, Callable

from .objectstore import HttpObjectStore, build_uri, parse_uri

logger = logging.getLogger(__name__)

TokenFn = Callable[[], Awaitable[str]]

_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/"
    "service-accounts/default/token"
)
_SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def service_account_assertion(info: dict[str, Any], now: float) -> str:
    """The self-signed RS256 JWT of a service-account key file's ``info``,
    issued at ``now`` for an hour (RFC 7523)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    claims = {
        "iss": info["client_email"],
        "scope": _SCOPE,
        "aud": info["token_uri"],
        "iat": int(now),
        "exp": int(now) + 3600,
    }
    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    key = serialization.load_pem_private_key(
        info["private_key"].encode(), password=None
    )
    sig = key.sign(
        f"{header}.{payload}".encode(), padding.PKCS1v15(), hashes.SHA256()
    )
    return f"{header}.{payload}.{_b64url(sig)}"


async def _token_from_service_account(path: str) -> tuple[str, float]:
    """Self-signed JWT → access token (RFC 7523 flow, no SDK)."""
    from .httpclient import ClientSession

    info = json.loads(await asyncio.to_thread(Path(path).read_text))
    now = time.time()
    assertion = service_account_assertion(info, now)
    async with ClientSession() as session:
        async with session.post(
            info["token_uri"],
            data={
                "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
                "assertion": assertion,
            },
        ) as resp:
            resp.raise_for_status()
            body = await resp.json()
    return body["access_token"], now + float(body.get("expires_in", 3600))


async def _token_from_metadata_server() -> tuple[str, float]:
    from .httpclient import ClientSession

    now = time.time()
    async with ClientSession() as session:
        async with session.get(
            _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"}
        ) as resp:
            resp.raise_for_status()
            body = await resp.json()
    return body["access_token"], now + float(body.get("expires_in", 3600))


class DefaultTokenProvider:
    """env var → service-account JSON → metadata server, with expiry cache."""

    def __init__(self):
        self._token = ""
        self._expires = 0.0
        self._lock = asyncio.Lock()

    async def __call__(self) -> str:
        env_tok = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if env_tok:
            return env_tok
        async with self._lock:
            if self._token and time.time() < self._expires - 60:
                return self._token
            sa_path = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
            if sa_path and Path(sa_path).is_file():
                self._token, self._expires = await _token_from_service_account(sa_path)
            else:
                self._token, self._expires = await _token_from_metadata_server()
            return self._token


class GCSObjectStore(HttpObjectStore):
    """GCS JSON-API object store (reference: ``S3Handler``, redesigned).

    Session/retry/download-to-file/fan-out plumbing comes from
    :class:`HttpObjectStore`; this class owns only the GCS wire protocol.
    """

    def __init__(
        self,
        *,
        endpoint: str = "https://storage.googleapis.com",
        token_fn: TokenFn | None = None,
        bucket_prefix: str = "",
        chunk_size: int = 1 << 20,
    ):
        super().__init__()
        self.endpoint = endpoint.rstrip("/")
        self._token_fn = token_fn or DefaultTokenProvider()
        #: optional real-bucket prefix so one GCS project can host several
        #: logical buckets (``obj://datasets/...`` → ``{prefix}datasets``)
        self.bucket_prefix = bucket_prefix
        self.chunk_size = chunk_size

    # -- plumbing ------------------------------------------------------------

    def _gcs_bucket(self, bucket: str) -> str:
        return f"{self.bucket_prefix}{bucket}"

    async def _headers(self) -> dict[str, str]:
        token = await self._token_fn()
        return {"Authorization": f"Bearer {token}"}

    def _object_url(self, uri: str, *, media: bool) -> str:
        bucket, key = parse_uri(uri)
        quoted = urllib.parse.quote(key, safe="")
        url = (
            f"{self.endpoint}/storage/v1/b/{self._gcs_bucket(bucket)}/o/{quoted}"
        )
        return f"{url}?alt=media" if media else url

    async def _call(
        self, method: str, url: str, *, data: bytes | None = None,
        params: dict[str, str] | None = None,
    ) -> tuple[int, bytes]:
        """One retried JSON-API request (token re-fetched per attempt so a
        retry spanning a token expiry still authenticates)."""

        async def build():
            session = await self.session()
            return session.request(
                method, url, data=data, params=params,
                headers=await self._headers(),
            )

        status, body, _ = await self.request_bytes(build)
        return status, body

    # -- ObjectStore interface -----------------------------------------------

    def _upload_url(self, uri: str) -> str:
        bucket, key = parse_uri(uri)
        return (
            f"{self.endpoint}/upload/storage/v1/b/{self._gcs_bucket(bucket)}/o"
            f"?uploadType=media&name={urllib.parse.quote(key, safe='')}"
        )

    async def put_bytes(self, uri: str, data: bytes) -> None:
        status, body = await self._call("POST", self._upload_url(uri), data=data)
        if status >= 300:
            raise IOError(f"GCS upload failed ({status}): {body[:200]!r}")

    async def put_stream(self, uri: str, chunks: AsyncIterator[bytes]) -> int:
        """Single-attempt: an async-iterator body cannot be replayed, so a
        transient failure surfaces to the caller (uploads with a replayable
        source should go through :meth:`put_file`/:meth:`put_bytes`)."""
        total = 0

        async def counted() -> AsyncIterator[bytes]:
            nonlocal total
            async for chunk in chunks:
                total += len(chunk)
                yield chunk

        session = await self.session()
        async with session.post(
            self._upload_url(uri), data=counted(), headers=await self._headers()
        ) as resp:
            if resp.status >= 300:
                raise IOError(f"GCS upload failed ({resp.status}): {await resp.text()}")
        return total

    async def put_file(self, uri: str, path: Path | str) -> None:
        p = Path(path)

        async def build():
            async def chunks() -> AsyncIterator[bytes]:
                with p.open("rb") as f:
                    while True:
                        chunk = await asyncio.to_thread(f.read, self.chunk_size)
                        if not chunk:
                            return
                        yield chunk

            session = await self.session()
            return session.post(
                self._upload_url(uri), data=chunks(),
                headers=await self._headers(),
            )

        # the chunk generator is rebuilt per attempt, so this upload IS
        # retryable, unlike a caller-supplied stream
        status, body, _ = await self.request_bytes(build)
        if status >= 300:
            raise IOError(f"GCS upload failed ({status}): {body[:200]!r}")

    async def get_bytes(self, uri: str) -> bytes:
        status, body = await self._call("GET", self._object_url(uri, media=True))
        if status == 404:
            raise FileNotFoundError(uri)
        if status >= 300:
            raise IOError(f"GCS get failed ({status})")
        return body

    async def get_chunks(self, uri: str, chunk_size: int = 1 << 20) -> AsyncIterator[bytes]:
        session = await self.session()
        async with session.get(
            self._object_url(uri, media=True), headers=await self._headers()
        ) as resp:
            if resp.status == 404:
                raise FileNotFoundError(uri)
            if resp.status >= 300:
                raise IOError(f"GCS get failed ({resp.status})")
            async for chunk in resp.content.iter_chunked(chunk_size):
                yield chunk

    async def exists(self, uri: str) -> bool:
        status, _ = await self._call("GET", self._object_url(uri, media=False))
        if status == 200:
            return True
        if status == 404:
            return False
        # a transient error must not read as "absent": copy_prefix branches
        # on this answer (exact-key vs prefix semantics)
        raise IOError(f"GCS head failed ({status}) for {uri}")

    async def size(self, uri: str) -> int | None:
        status, body = await self._call("GET", self._object_url(uri, media=False))
        if status == 404:
            raise FileNotFoundError(uri)
        if status >= 300:
            raise IOError(f"GCS head failed ({status}) for {uri}")
        try:
            return int(json.loads(body).get("size"))
        except (ValueError, TypeError):
            return None

    async def list_prefix(self, prefix_uri: str) -> list[dict[str, Any]]:
        bucket, key = parse_uri(prefix_uri)
        base = f"{self.endpoint}/storage/v1/b/{self._gcs_bucket(bucket)}/o"
        out: list[dict[str, Any]] = []
        page: str | None = None
        while True:
            params = {"prefix": key}
            if page:
                params["pageToken"] = page
            status, body = await self._call("GET", base, params=params)
            if status >= 300:
                raise IOError(f"GCS list failed ({status})")
            doc = json.loads(body)
            for item in doc.get("items", []):
                out.append(
                    {
                        "uri": build_uri(bucket, item["name"]),
                        "size": int(item.get("size", 0)),
                        "mtime": self.parse_iso_mtime(item.get("updated", "")),
                    }
                )
            page = doc.get("nextPageToken")
            if not page:
                return out

    async def delete_prefix(self, prefix_uri: str) -> int:
        objs = await self.list_prefix(prefix_uri)

        async def delete_one(o) -> int:
            status, _ = await self._call(
                "DELETE", self._object_url(o["uri"], media=False)
            )
            if status in (200, 204, 404):
                return 1
            raise IOError(f"GCS delete failed ({status}) for {o['uri']}")

        return sum(await self.map_concurrently(delete_one, objs))

    async def copy_prefix(self, src_uri: str, dst_uri: str) -> int:
        """Server-side copy per object (reference: ``S3Handler.py:375-439`` —
        head the key; on miss treat as prefix), fanned out concurrently."""
        if await self.exists(src_uri):
            objs = [{"uri": src_uri}]
            exact = True
        else:
            objs = await self.list_prefix(src_uri)
            exact = False
        _, src_key = parse_uri(src_uri)
        dst_bucket, dst_key = parse_uri(dst_uri)

        async def copy_one(o) -> int:
            src_b, key = parse_uri(o["uri"])
            rel = "" if exact else key[len(src_key):].lstrip("/")
            target_key = dst_key if exact else f"{dst_key}/{rel}" if rel else dst_key
            url = (
                f"{self.endpoint}/storage/v1/b/{self._gcs_bucket(src_b)}/o/"
                f"{urllib.parse.quote(key, safe='')}/copyTo/b/"
                f"{self._gcs_bucket(dst_bucket)}/o/"
                f"{urllib.parse.quote(target_key, safe='')}"
            )
            status, _ = await self._call("POST", url)
            if status >= 300:
                raise IOError(f"GCS copy failed ({status}) for {o['uri']}")
            return 1

        return sum(await self.map_concurrently(copy_one, objs))
