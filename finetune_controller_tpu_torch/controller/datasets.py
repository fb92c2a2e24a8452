"""Dataset ingestion helpers: file upload, URL streaming, record keeping.

Capability parity with the reference's ``app/utils/dataset_helpers.py``
(SURVEY.md §2 component 18): save-upload-cleanup for file uploads (:20-57),
zero-copy URL → object-store streaming (:113-145), filename extraction from
``Content-Disposition`` (:60-70) — plus the dataset-record bookkeeping the
reference's API layer does inline (``app/main.py:953-1060``).
"""

from __future__ import annotations

import asyncio
import logging
import re
import urllib.error
import urllib.request
from typing import Any, AsyncIterator
from urllib.parse import unquote, urlparse

from .objectstore import ObjectStore, build_uri
from .schemas import DatasetRecord
from .statestore import StateStore, generate_short_uuid

logger = logging.getLogger(__name__)

_DISPOSITION_RE = re.compile(r"filename\*?=(?:UTF-8''|\"?)([^\";]+)", re.IGNORECASE)


def filename_from_content_disposition(header: str | None) -> str | None:
    """Reference: ``dataset_helpers.py:60-70``."""
    if not header:
        return None
    m = _DISPOSITION_RE.search(header)
    return unquote(m.group(1).strip()) if m else None


def dataset_uri_for(bucket: str, user_id: str, dataset_id: str, filename: str) -> str:
    return build_uri(bucket, "datasets", user_id, dataset_id, filename)


async def upload_dataset_bytes(
    store: ObjectStore,
    state: StateStore,
    *,
    user_id: str,
    filename: str,
    data: bytes,
    bucket: str,
    content_type: str | None = None,
    name: str | None = None,
) -> DatasetRecord:
    """File-upload path (reference: ``upload_dataset_file``,
    ``dataset_helpers.py:20-57`` — minus the tmp-file hop, since the object
    store accepts bytes directly)."""
    dataset_id = generate_short_uuid()
    uri = dataset_uri_for(bucket, user_id, dataset_id, filename)
    await store.put_bytes(uri, data)
    record = DatasetRecord(
        dataset_id=dataset_id,
        user_id=user_id,
        name=name or filename,
        uri=uri,
        size_bytes=len(data),
        content_type=content_type,
    )
    await state.insert_dataset(record)
    return record


async def upload_dataset_stream(
    store: ObjectStore,
    state: StateStore,
    *,
    user_id: str,
    filename: str,
    chunks: AsyncIterator[bytes],
    bucket: str,
    content_type: str | None = None,
    name: str | None = None,
) -> DatasetRecord:
    """Streaming upload — no full-file buffering (the zero-copy property of
    the reference's URL path, ``dataset_helpers.py:113-145``)."""
    dataset_id = generate_short_uuid()
    uri = dataset_uri_for(bucket, user_id, dataset_id, filename)
    size = await store.put_stream(uri, chunks)
    record = DatasetRecord(
        dataset_id=dataset_id,
        user_id=user_id,
        name=name or filename,
        uri=uri,
        size_bytes=size,
        content_type=content_type,
    )
    await state.insert_dataset(record)
    return record


async def stream_dataset_url(
    store: ObjectStore,
    state: StateStore,
    *,
    user_id: str,
    url: str,
    bucket: str,
    session: Any | None = None,
    chunk_size: int = 1 << 20,
) -> DatasetRecord:
    """Download a dataset URL straight into the object store (reference:
    ``stream_dataset_url``, ``dataset_helpers.py:113-145``): the HTTP body is
    piped chunk-by-chunk, never buffered whole.

    ``session`` is an injected ``urllib`` opener (anything with
    ``open(url, timeout=...)``, the test seam); the default opener is used
    when omitted.  Every blocking read runs in a worker thread.
    """
    opener = session if session is not None else urllib.request.build_opener()
    try:
        resp = await asyncio.to_thread(opener.open, url, timeout=60)
    except urllib.error.HTTPError as e:
        raise ValueError(f"dataset URL returned HTTP {e.code}") from e
    try:
        if resp.status != 200:
            raise ValueError(f"dataset URL returned HTTP {resp.status}")
        filename = (
            filename_from_content_disposition(resp.headers.get("Content-Disposition"))
            or unquote(urlparse(url).path.rsplit("/", 1)[-1])
            or "dataset.bin"
        )
        content_type = resp.headers.get("Content-Type")

        async def chunks() -> AsyncIterator[bytes]:
            while chunk := await asyncio.to_thread(resp.read, chunk_size):
                yield chunk

        return await upload_dataset_stream(
            store, state,
            user_id=user_id, filename=filename, chunks=chunks(),
            bucket=bucket, content_type=content_type, name=url,
        )
    finally:
        await asyncio.to_thread(resp.close)
