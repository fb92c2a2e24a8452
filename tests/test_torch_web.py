"""The port's stdlib HTTP server (``controller/web.py``) on request bodies.

A body stays on the socket until the handler reads it.  A multipart body
streams past the app's ``client_max_size`` with bounded memory — through
the port's own ``POST /datasets`` route and through a bare handler, sized
and chunked — while ``read()`` refuses a larger body with 413.  A body the
handler leaves unread is drained so the connection serves its next
request, and a malformed ``Content-Length`` answers 400.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import sys
import threading
import tracemalloc
import urllib.request
from pathlib import Path

import pytest

from finetune_controller_tpu_torch.controller import web

LIMIT = 1 << 20  # the apps' client_max_size here
UPLOAD = bytes(range(256)) * (6 * LIMIT // 256)  # a 6 MiB file part
#: most bytes the server side may hold while a 6 MiB upload streams through
#: (buffering the body whole would take at least 6 MiB)
PEAK_BOUND = 2 * LIMIT
BOUNDARY = "webtestboundary42"


class _Served:
    """An application served on its own event-loop thread."""

    def __init__(self, app):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.runner = web.AppRunner(app)
        self.call(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.call(site.start())
        self.port = site.port

    def call(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        try:
            self.call(self.runner.cleanup())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


def _multipart(file_field: str, payload: bytes, after: dict[str, str]) -> bytes:
    head = (f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="{file_field}"; '
            f'filename="train.jsonl"\r\nContent-Type: application/jsonl\r\n\r\n').encode()
    tail = b"".join(f'\r\n--{BOUNDARY}\r\nContent-Disposition: form-data; name="{k}"'
                    f'\r\n\r\n{v}'.encode() for k, v in after.items())
    return head + payload + tail + f"\r\n--{BOUNDARY}--\r\n".encode()


async def _exchange(port: int, requests: list[bytes]) -> list[tuple[int, bytes]]:
    """Send ``requests`` on one connection, one after another, and read each
    response (sized bodies only)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    try:
        for raw in requests:
            for i in range(0, len(raw), 1 << 16):
                writer.write(raw[i:i + (1 << 16)])
                await writer.drain()
            head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
            status = int(head.split(" ", 2)[1])
            length = next((int(line.split(":", 1)[1]) for line in head.split("\r\n")
                           if line.lower().startswith("content-length:")), 0)
            out.append((status, await reader.readexactly(length)))
    finally:
        writer.close()
    return out


def _chunked(body: bytes, size: int = 50_000) -> bytes:
    out = bytearray()
    for i in range(0, len(body), size):
        piece = body[i:i + size]
        out += b"%x\r\n" % len(piece) + piece + b"\r\n"
    return bytes(out + b"0\r\n\r\n")


def _post(path: str, body: bytes, *, chunked: bool, content_type: str) -> bytes:
    framing = (b"Transfer-Encoding: chunked\r\n" if chunked
               else b"Content-Length: %d\r\n" % len(body))
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: {content_type}\r\n".encode()
            + framing + b"\r\n" + (_chunked(body) if chunked else body))


@pytest.fixture(scope="module")
def bare():
    """An app with two routes: one that streams a multipart body into a
    hash, one that reads its body whole."""

    async def stream(request):
        digest, sizes, fields = hashlib.sha256(), [], {}
        async for part in await request.multipart():
            if part.filename:
                while chunk := await part.read_chunk(1 << 20):
                    digest.update(chunk)
                    sizes.append(len(chunk))
            else:
                fields[part.name] = (await part.read()).decode()
        return web.json_response({"sha256": digest.hexdigest(), "bytes": sum(sizes),
                                  "fields": fields})

    async def whole(request):
        return web.json_response({"bytes": len(await request.read())})

    async def ignore(request):
        return web.json_response({"ok": True})

    app = web.Application(client_max_size=LIMIT)
    app.router.add_post("/stream", stream)
    app.router.add_post("/whole", whole)
    app.router.add_post("/ignore", ignore)
    served = _Served(app)
    yield served
    served.close()


@pytest.mark.parametrize("chunked", [False, True], ids=["sized", "chunked"])
def test_multipart_streams_past_client_max_size_in_bounded_memory(bare, chunked):
    raw = _post("/stream", _multipart("file", UPLOAD, {"note": "after the file"}),
                chunked=chunked, content_type=f"multipart/form-data; boundary={BOUNDARY}")
    tracemalloc.start()
    try:
        [(status, body)] = bare.call(_exchange(bare.port, [raw]))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert status == 200, body
    got = json.loads(body)
    assert got == {"sha256": hashlib.sha256(UPLOAD).hexdigest(), "bytes": len(UPLOAD),
                   "fields": {"note": "after the file"}}
    assert peak < PEAK_BOUND, peak


@pytest.mark.parametrize("chunked", [False, True], ids=["sized", "chunked"])
def test_read_refuses_a_body_past_client_max_size(bare, chunked):
    small, big = b"x" * 1000, b"x" * (LIMIT + 1)
    replies = bare.call(_exchange(bare.port, [
        _post("/whole", small, chunked=chunked, content_type="application/octet-stream"),
        _post("/whole", big, chunked=chunked, content_type="application/octet-stream")]))
    assert replies[0] == (200, b'{"bytes": 1000}')
    assert replies[1][0] == 413
    assert replies[1][1].startswith(f"Maximum request body size {LIMIT} exceeded".encode())


def test_unread_body_is_drained_and_the_connection_serves_the_next_request(bare):
    body = _multipart("file", b"y" * 300_000, {})
    ctype = f"multipart/form-data; boundary={BOUNDARY}"
    replies = bare.call(_exchange(bare.port, [
        _post("/ignore", body, chunked=False, content_type=ctype),
        _post("/ignore", body, chunked=True, content_type=ctype),
        _post("/stream", body, chunked=False, content_type=ctype)]))
    assert [s for s, _ in replies] == [200, 200, 200]
    assert json.loads(replies[2][1])["bytes"] == 300_000


@pytest.mark.parametrize("value", ["-1", "12abc", "0x10"])
def test_malformed_content_length_answers_400(bare, value):
    raw = (f"POST /whole HTTP/1.1\r\nHost: x\r\nContent-Length: {value}\r\n\r\n"
           .encode())
    [(status, body)] = bare.call(_exchange(bare.port, [raw]))
    assert status == 400 and b"invalid Content-Length" in body


def test_dataset_upload_streams_into_the_object_store(tmp_path):
    """``POST /datasets`` of the port's server stores a file larger than the
    app's ``client_max_size`` without holding it in memory."""
    from finetune_controller_tpu_torch.controller import (
        config, devices, monitor, objectstore, runtime, server, statestore)
    from finetune_controller_tpu_torch.controller.backends.local import LocalProcessBackend

    settings = config.Settings(state_dir=str(tmp_path / "state"),
                               object_store_root=str(tmp_path / "objects"))
    state = statestore.StateStore(settings.state_path)
    store = objectstore.LocalObjectStore(settings.object_store_path)
    catalog = devices.default_catalog()
    backend = LocalProcessBackend(settings.state_path / "sandboxes", store, catalog,
                                  python=sys.executable)
    rt = runtime.Runtime(
        settings=settings, state=state, store=store, catalog=catalog, backend=backend,
        monitor=monitor.JobMonitor(state, store, backend, interval_s=0.1),
        presigner=objectstore.Presigner(settings.presign_secret))
    app = server.build_app(rt)
    app.client_max_size = LIMIT
    served = _Served(app)
    try:
        body = _multipart("file", UPLOAD, {})
        req = urllib.request.Request(
            f"http://127.0.0.1:{served.port}{settings.api_prefix}/datasets", data=body,
            method="POST",
            headers={"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
        tracemalloc.start()
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                status, record = resp.status, json.loads(resp.read())
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
    finally:
        served.close()
    assert status == 201 and record["size_bytes"] == len(UPLOAD), record
    stored = next(Path(settings.object_store_path).rglob("train.jsonl"))
    assert stored.read_bytes() == UPLOAD
    assert peak < PEAK_BOUND, peak
