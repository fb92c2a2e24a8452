"""Pluggable object store for datasets and training artifacts.

Capability parity with the reference's ``S3Handler`` (``app/utils/S3Handler.py``,
443 LoC — SURVEY.md §2 component 9): dataset upload (bytes / file / async
stream), the ``finetune_jobs/{user}/{job}/{dataset|artifacts}`` URI convention
(``S3Handler.py:46-71``), presigned download URLs (``:168``), newest-metrics-CSV
fetch (``:237-292``, read with the ``csv`` module to the JSON the
reference's pandas path gives), artifact zip streaming (``:294-373``), recursive
copy for promotion (``:375-439``) and prefix cleanup (``:216-235``).

The default backend is a local-filesystem store (``obj://bucket/key`` URIs) so
the whole control plane runs hermetically in CI; the GCS and S3 backends
(``controller/gcs.py``, ``controller/s3.py``) slot in behind the same
:class:`ObjectStore` interface, on :class:`HttpObjectStore` and the port's
stdlib HTTP client (``controller/httpclient.py``).
"""

from __future__ import annotations

import asyncio
import csv
import hashlib
import hmac
import io
import math
import re
import shutil
import time
import zipfile
from pathlib import Path
from typing import Any, AsyncIterator

URI_SCHEME = "obj://"


def build_uri(bucket: str, *parts: str) -> str:
    key = "/".join(p.strip("/") for p in parts if p)
    return f"{URI_SCHEME}{bucket}/{key}"


def parse_uri(uri: str) -> tuple[str, str]:
    if not uri.startswith(URI_SCHEME):
        raise ValueError(f"not an object-store uri: {uri!r}")
    bucket, _, key = uri[len(URI_SCHEME) :].partition("/")
    return bucket, key


def dataset_prefix(bucket: str, user_id: str, job_id: str) -> str:
    """Reference convention ``S3Handler.py:46-62``."""
    return build_uri(bucket, "finetune_jobs", user_id, job_id, "dataset")


def artifacts_prefix(bucket: str, user_id: str, job_id: str) -> str:
    """Reference convention ``S3Handler.py:63-71``."""
    return build_uri(bucket, "finetune_jobs", user_id, job_id, "artifacts")


#: cells the reference's ``pandas.read_csv`` reads as missing (its default
#: ``na_values``)
_NA_CELLS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT_RE = re.compile(r"[+-]?\d+")
_FLOAT_RE = re.compile(
    r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)",
    re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


def _typed_column(cells: list[str | None]) -> list[Any]:
    """One column's cells typed as ``pandas.read_csv`` types them: all
    integers → ``int`` (``float`` once a cell is missing), all numbers →
    ``float``, all booleans → ``bool``, else the text; missing → ``None``."""
    present = [c for c in cells if c is not None]
    missing = len(present) < len(cells)
    if present and all(_INT_RE.fullmatch(c) for c in present):
        kind = float if missing else int
    elif present and all(_FLOAT_RE.fullmatch(c) for c in present):
        kind = float
    elif present and all(c in _BOOLS for c in present):
        kind = _BOOLS.__getitem__
    else:
        kind = str
    out = []
    for c in cells:
        v = None if c is None else kind(c)
        out.append(None if isinstance(v, float) and math.isnan(v) else v)
    return out


def read_csv_records(raw: bytes) -> list[dict[str, Any]]:
    """A metrics CSV as JSON-ready records: the reference's
    ``pd.read_csv(...).astype(object).where(notna, None).to_dict("records")``
    on the ``csv`` module (short rows pad with missing cells)."""
    rows = list(csv.reader(io.StringIO(raw.decode("utf-8"))))
    if not rows:
        return []
    header, body = rows[0], [r for r in rows[1:] if r]
    columns = []
    for i in range(len(header)):
        cells = [r[i] if i < len(r) else "" for r in body]
        columns.append(_typed_column([None if c in _NA_CELLS else c for c in cells]))
    return [{name: col[j] for name, col in zip(header, columns)}
            for j in range(len(body))]


class ObjectStore:
    """Abstract async object store."""

    async def close(self) -> None:
        """Release network resources (no-op for local stores)."""

    async def put_bytes(self, uri: str, data: bytes) -> None:
        raise NotImplementedError

    async def put_stream(self, uri: str, chunks: AsyncIterator[bytes]) -> int:
        raise NotImplementedError

    async def put_file(self, uri: str, path: Path | str) -> None:
        raise NotImplementedError

    async def get_bytes(self, uri: str) -> bytes:
        raise NotImplementedError

    async def get_file(self, uri: str, dest: Path | str) -> int:
        """Stream an object to a local file without buffering it whole;
        returns bytes written."""
        raise NotImplementedError

    async def exists(self, uri: str) -> bool:
        raise NotImplementedError

    async def size(self, uri: str) -> int | None:
        """Byte size of an object via a cheap stat (os.stat / HEAD), or
        ``None`` when the backend has no such operation — callers must then
        fall back to reading.  Raises ``FileNotFoundError`` for a missing
        object (the ``get_bytes`` convention), so pollers can distinguish
        "not there yet" from "can't stat"."""
        return None

    async def list_prefix(self, prefix_uri: str) -> list[dict[str, Any]]:
        """Return [{"uri", "size", "mtime"}] under a prefix."""
        raise NotImplementedError

    async def delete_prefix(self, prefix_uri: str) -> int:
        raise NotImplementedError

    async def copy_prefix(self, src_uri: str, dst_uri: str) -> int:
        raise NotImplementedError

    async def get_chunks(self, uri: str, chunk_size: int = 1 << 20) -> AsyncIterator[bytes]:
        """Stream an object's bytes in chunks. Default materializes the whole
        object (backends override with true streaming)."""
        data = await self.get_bytes(uri)
        for i in range(0, len(data), chunk_size):
            yield data[i : i + chunk_size]

    # -- shared higher-level helpers -----------------------------------------

    async def get_metrics_records(self, artifacts_uri: str) -> tuple[list[dict[str, Any]], str] | None:
        """Pick the newest ``*metrics*.csv`` under the artifacts prefix and
        parse it to records (reference: ``S3Handler.py:237-292``)."""
        objs = await self.list_prefix(artifacts_uri)
        csvs = [o for o in objs if "metrics" in Path(o["uri"]).name and o["uri"].endswith(".csv")]
        if not csvs:
            return None
        newest = max(csvs, key=lambda o: o["mtime"])
        raw = await self.get_bytes(newest["uri"])
        if not raw.strip():
            # the artifact sync can ship metrics.csv between creation and the
            # first row landing — "no metrics yet", not an error
            return None
        # Ragged rows (e.g. eval columns written on their own cadence) read
        # as None — NaN is RFC-invalid in the JSON API and breaks the
        # monitor's records-unchanged compare (NaN != NaN).
        records = await asyncio.to_thread(read_csv_records, raw)
        return records, newest["uri"]

    async def zip_prefix(self, prefix_uri: str) -> bytes:
        """Zip every object under a prefix, in memory — small prefixes only
        (reference: ``S3Handler.py:294-373``)."""
        objs = await self.list_prefix(prefix_uri)
        _, prefix_key = parse_uri(prefix_uri)
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for o in objs:
                _, key = parse_uri(o["uri"])
                arcname = key[len(prefix_key) :].lstrip("/") if key.startswith(prefix_key) else key
                zf.writestr(arcname, await self.get_bytes(o["uri"]))
        return buf.getvalue()

    async def zip_prefix_to_path(self, prefix_uri: str, dest: Path | str) -> int:
        """Zip a prefix to a file on disk, streaming each object in chunks —
        bounded memory even when a single object (e.g. a checkpoint shard) is
        multi-GB. Returns object count."""
        objs = await self.list_prefix(prefix_uri)
        _, prefix_key = parse_uri(prefix_uri)
        with zipfile.ZipFile(dest, "w", zipfile.ZIP_DEFLATED) as zf:
            for o in objs:
                _, key = parse_uri(o["uri"])
                arcname = (
                    key[len(prefix_key) :].lstrip("/")
                    if key.startswith(prefix_key) else key
                )
                zi = zipfile.ZipInfo(arcname)
                zi.compress_type = zipfile.ZIP_DEFLATED
                with zf.open(zi, "w") as entry:
                    async for chunk in self.get_chunks(o["uri"]):
                        await asyncio.to_thread(entry.write, chunk)
        return len(objs)


class HttpObjectStore(ObjectStore):
    """Shared HTTP plumbing for the cloud backends (GCS and S3 both
    inherit this), on the port's stdlib client (``controller/httpclient.py``
    in the place of the reference's ``aiohttp``): lazy session with one
    timeout policy, retry/backoff on
    transient failures, chunked download-to-file with atomic rename, ISO-8601
    mtime parsing, bounded-concurrency fan-out.  One copy so a fix lands in
    every cloud engine (the reference gets all of this from aioboto3 —
    ``S3Handler.py:12,25``)."""

    chunk_size: int = 1 << 20
    #: transient-failure policy: one transfer survives `retry_attempts - 1`
    #: 5xx/429/connection hiccups (the in-repo kube client's pattern —
    #: ``backends/k8s.py``); tests zero `retry_base_delay` for speed
    retry_attempts: int = 4
    retry_base_delay: float = 0.25
    retry_statuses: frozenset = frozenset({429, 500, 502, 503, 504})
    #: concurrent requests for prefix-wide operations (delete/copy fan-out —
    #: the reference batches with asyncio.gather, ``S3Handler.py:330,422``)
    prefix_concurrency: int = 16

    def __init__(self):
        self._session = None

    async def session(self):
        from . import httpclient

        if self._session is None or self._session.closed:
            self._session = httpclient.ClientSession(
                timeout=httpclient.ClientTimeout(total=None, connect=30)
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    def _retry_delay(self, done_attempts: int) -> float:
        return self.retry_base_delay * (2 ** done_attempts)

    async def request_bytes(self, build) -> tuple[int, bytes, dict[str, str]]:
        """Send one logical request with retries; returns
        ``(status, body, headers)`` for the first conclusive outcome.

        ``build()`` must return a FRESH response context manager per
        call — it is re-invoked on every attempt so signed engines re-stamp
        dates/signatures.  Retries connection errors/timeouts and
        ``retry_statuses`` with exponential backoff; the final attempt's
        outcome (status or exception) is returned/raised as-is so call sites
        keep their own error mapping.
        """
        from .httpclient import ClientError

        last = self.retry_attempts - 1
        for attempt in range(self.retry_attempts):
            if attempt:
                await asyncio.sleep(self._retry_delay(attempt - 1))
            try:
                async with await build() as resp:
                    body = await resp.read()
                    if resp.status in self.retry_statuses and attempt < last:
                        continue
                    return resp.status, body, dict(resp.headers)
            except (ClientError, asyncio.TimeoutError):
                if attempt >= last:
                    raise
        raise AssertionError("unreachable")

    async def get_file(self, uri: str, dest: Path | str) -> int:
        """Stream to a local file with atomic rename; transient mid-transfer
        failures restart the WHOLE transfer (objects are immutable here, and
        a restart is simpler and safer than byte-range resumption)."""
        from .httpclient import ClientError

        dest_p = Path(dest)
        dest_p.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest_p.with_name(dest_p.name + ".tmp")
        last = self.retry_attempts - 1
        try:
            for attempt in range(self.retry_attempts):
                if attempt:
                    await asyncio.sleep(self._retry_delay(attempt - 1))
                total = 0
                try:
                    with tmp.open("wb") as f:
                        async for chunk in self.get_chunks(uri, self.chunk_size):
                            total += len(chunk)
                            await asyncio.to_thread(f.write, chunk)
                    tmp.replace(dest_p)
                    return total
                except FileNotFoundError:
                    raise  # a 404 is conclusive, not transient
                except (IOError, ClientError, asyncio.TimeoutError):
                    if attempt >= last:
                        raise
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        raise AssertionError("unreachable")

    async def map_concurrently(self, fn, items: list) -> list:
        """Run ``fn(item)`` over items with bounded concurrency. Waits for
        EVERY task before returning or raising (no orphaned requests keep
        mutating the bucket after the caller has observed a failure), then
        re-raises the first failure."""
        if not items:
            return []
        sem = asyncio.Semaphore(self.prefix_concurrency)

        async def guarded(item):
            async with sem:
                return await fn(item)

        results = await asyncio.gather(
            *(guarded(i) for i in items), return_exceptions=True
        )
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    @staticmethod
    def parse_iso_mtime(text: str) -> float:
        try:
            return __import__("datetime").datetime.fromisoformat(
                text.replace("Z", "+00:00")
            ).timestamp()
        except ValueError:
            return 0.0


class LocalObjectStore(ObjectStore):
    """Filesystem-backed store rooted at ``root/<bucket>/<key>``."""

    def __init__(self, root: Path | str):
        self.root = Path(root).expanduser()

    def path_for(self, uri: str) -> Path:
        bucket, key = parse_uri(uri)
        base = (self.root / bucket).resolve()
        p = (self.root / bucket / key).resolve()
        if p != base and not p.is_relative_to(base):
            raise ValueError(f"path escape in uri {uri!r}")
        return p

    async def put_bytes(self, uri: str, data: bytes) -> None:
        def write() -> None:
            p = self.path_for(uri)
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_name(p.name + ".tmp")
            tmp.write_bytes(data)
            tmp.replace(p)

        await asyncio.to_thread(write)

    async def put_stream(self, uri: str, chunks: AsyncIterator[bytes]) -> int:
        """Zero-copy-ish streaming upload (reference: URL→S3 streaming,
        ``dataset_helpers.py:113-145``)."""
        p = self.path_for(uri)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        total = 0
        with tmp.open("wb") as f:
            async for chunk in chunks:
                total += len(chunk)
                await asyncio.to_thread(f.write, chunk)
        tmp.replace(p)
        return total

    async def put_file(self, uri: str, path: Path | str) -> None:
        def copy() -> None:
            p = self.path_for(uri)
            p.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(path, p)

        await asyncio.to_thread(copy)

    async def get_bytes(self, uri: str) -> bytes:
        return await asyncio.to_thread(self.path_for(uri).read_bytes)

    async def get_file(self, uri: str, dest: Path | str) -> int:
        src = self.path_for(uri)

        def copy() -> int:
            dest_p = Path(dest)
            dest_p.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(src, dest_p)
            return dest_p.stat().st_size

        return await asyncio.to_thread(copy)

    async def get_chunks(self, uri: str, chunk_size: int = 1 << 20) -> AsyncIterator[bytes]:
        p = self.path_for(uri)
        with p.open("rb") as f:
            while True:
                chunk = await asyncio.to_thread(f.read, chunk_size)
                if not chunk:
                    return
                yield chunk

    async def exists(self, uri: str) -> bool:
        return await asyncio.to_thread(self.path_for(uri).exists)

    async def size(self, uri: str) -> int | None:
        return (await asyncio.to_thread(self.path_for(uri).stat)).st_size

    async def list_prefix(self, prefix_uri: str) -> list[dict[str, Any]]:
        bucket, key = parse_uri(prefix_uri)

        def scan() -> list[dict[str, Any]]:
            base = self.root / bucket / key
            if not base.exists():
                return []
            out = []
            for p in sorted(base.rglob("*")):
                if p.is_file() and not p.name.endswith(".tmp"):
                    rel = p.relative_to(self.root / bucket)
                    st = p.stat()
                    out.append(
                        {
                            "uri": build_uri(bucket, str(rel)),
                            "size": st.st_size,
                            "mtime": st.st_mtime,
                        }
                    )
            return out

        return await asyncio.to_thread(scan)

    async def delete_prefix(self, prefix_uri: str) -> int:
        """Reference: ``S3Handler.py:216-235``."""
        objs = await self.list_prefix(prefix_uri)

        def rm() -> None:
            bucket, key = parse_uri(prefix_uri)
            base = self.root / bucket / key
            if base.is_dir():
                shutil.rmtree(base)
            elif base.exists():
                base.unlink()

        await asyncio.to_thread(rm)
        return len(objs)

    async def copy_prefix(self, src_uri: str, dst_uri: str) -> int:
        """Recursive copy for promotion (reference: ``S3Handler.py:375-439`` —
        head the key; on miss treat as prefix and copy each object)."""
        src_path = self.path_for(src_uri)
        if src_path.is_file():
            await self.put_bytes(dst_uri, await self.get_bytes(src_uri))
            return 1
        objs = await self.list_prefix(src_uri)
        _, src_key = parse_uri(src_uri)
        dst_bucket, dst_key = parse_uri(dst_uri)
        n = 0
        for o in objs:
            _, key = parse_uri(o["uri"])
            rel = key[len(src_key) :].lstrip("/")
            await self.put_bytes(
                build_uri(dst_bucket, dst_key, rel), await self.get_bytes(o["uri"])
            )
            n += 1
        return n


def build_object_store(settings) -> ObjectStore:
    """Object-store factory from settings: ``local`` (hermetic CI), ``gcs``
    (``controller.gcs``), or ``s3`` (``controller.s3`` — SigV4 over the stdlib client,
    the layout-compatible migration path off the reference). The seam the
    reference hardwires to aioboto3 (``S3Handler.py:12,25``)."""
    backend = getattr(settings, "object_store_backend", "local")
    if backend == "local":
        return LocalObjectStore(settings.object_store_path)
    if backend == "gcs":
        from .gcs import GCSObjectStore

        return GCSObjectStore(
            endpoint=settings.gcs_endpoint,
            bucket_prefix=settings.gcs_bucket_prefix,
        )
    if backend == "s3":
        from .s3 import S3ObjectStore

        return S3ObjectStore(
            endpoint=settings.s3_endpoint,
            region=settings.s3_region,
            bucket_prefix=settings.s3_bucket_prefix,
        )
    raise ValueError(f"unknown object_store_backend {backend!r}")



class Presigner:
    """HMAC presigned-download tokens (reference: S3 presigned URLs,
    ``S3Handler.py:168-214``; ours are served by the API's ``/download`` route
    since the local store has no external endpoint)."""

    def __init__(self, secret: str, expiry_s: int = 3600):
        self._secret = secret.encode()
        self._expiry_s = expiry_s

    def sign(self, uri: str, now: float | None = None) -> str:
        expires = int((now if now is not None else time.time()) + self._expiry_s)
        mac = hmac.new(self._secret, f"{uri}:{expires}".encode(), hashlib.sha256)
        return f"{expires}.{mac.hexdigest()}"

    def verify(self, uri: str, token: str, now: float | None = None) -> bool:
        try:
            expires_s, digest = token.split(".", 1)
            expires = int(expires_s)
        except ValueError:
            return False
        if (now if now is not None else time.time()) > expires:
            return False
        mac = hmac.new(self._secret, f"{uri}:{expires}".encode(), hashlib.sha256)
        return hmac.compare_digest(mac.hexdigest(), digest)
