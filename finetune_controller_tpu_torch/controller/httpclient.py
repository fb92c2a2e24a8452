"""A small asyncio HTTP/1.1 client offering the part of ``aiohttp``'s
client that the control plane's HTTP object stores and the remote state
store use.

``controller/web.py`` stands in for ``aiohttp.web`` on the server side, for
the same reason: the port may not import ``aiohttp``
(``tests/test_torch_import.py``).  The names follow ``aiohttp`` so the
callers (``objectstore.HttpObjectStore``, ``s3.py``, ``gcs.py``,
``statestore_service.RemoteStateStore``) read as the reference's do:

* :class:`ClientSession` — ``request``/``get``/``post`` as ``async with
  session.request(...) as resp`` (or awaited), default headers, ``close``;
  ``ws_connect`` for a client WebSocket;
* :class:`ClientResponse` — ``status``, ``headers``, ``read()``,
  ``text()``, ``json()``, ``content.iter_chunked(n)`` and ``async for line
  in content`` (the body read as a stream of chunks or of lines),
  ``raise_for_status()``;
* :class:`ClientTimeout` — ``total`` (the whole request, body included),
  ``connect`` and ``sock_read`` (each read of the socket);
* :class:`ClientError` and its subclasses, all ``OSError``\\ s.

Request bodies are bytes, text, a form (a dict, sent urlencoded), JSON
(``json=``) or an async iterator of bytes (sent chunked).  Responses are
sized, chunked or read to the connection's end.  A connection whose
response was read to its end goes back to a per-host pool and carries the
next request; a pooled connection the server closed meanwhile is replaced
once, for a body that can be sent again.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import dataclasses
import json as jsonlib
import os
import ssl
import time
from typing import Any, AsyncIterator, Callable
from urllib.parse import urlencode, urlsplit

from .web import CIDict, WebSocketConnection, ws_accept_key

_READ_BYTES = 64 * 1024
#: the socket's read buffer (asyncio pauses the transport at twice this),
#: which also bounds a response head: large enough that a 1 MiB chunk of
#: a download is one read
_BUFFER_BYTES = 1024 * 1024
#: idle connections kept per (scheme, host, port)
_POOL_PER_HOST = 8


class ClientError(OSError):
    """Base of the client's errors (``aiohttp.ClientError``)."""


class ClientConnectionError(ClientError):
    pass


class ClientConnectorError(ClientConnectionError):
    """The connection could not be opened."""


class ServerDisconnectedError(ClientConnectionError):
    """The server closed the connection before the response was whole."""


class ClientPayloadError(ClientError):
    """The response body was malformed."""


class ClientResponseError(ClientError):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"{status}, message={message!r}")
        self.status = status
        self.message = message


class ContentTypeError(ClientResponseError):
    pass


class WSServerHandshakeError(ClientResponseError):
    pass


@dataclasses.dataclass(frozen=True)
class ClientTimeout:
    total: float | None = None
    connect: float | None = None
    sock_read: float | None = None


DEFAULT_TIMEOUT = ClientTimeout(total=300.0)


class _Deadline:
    """The time left of a request's ``total`` budget, capped per read by
    ``sock_read``."""

    def __init__(self, timeout: ClientTimeout):
        self.timeout = timeout
        self.end = None if timeout.total is None else time.monotonic() + timeout.total

    def left(self, cap: float | None) -> float | None:
        if self.end is None:
            return cap
        left = self.end - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"request exceeded its total timeout of {self.timeout.total} s")
        return left if cap is None else min(left, cap)

    async def io(self, aw, cap: float | None = None):
        return await asyncio.wait_for(aw, self.left(cap if cap is not None
                                                    else self.timeout.sock_read))


class _Conn:
    def __init__(self, key: tuple, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.key = key
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self.writer.close()


class StreamReader:
    """A response body as the server sends it: ``read(n)`` gives up to ``n``
    bytes (``b""`` at the end), ``iter_chunked(n)`` iterates them,
    ``readline()`` gives one line with its ``\\n`` (the last one may lack
    it) and ``async for line in reader`` iterates the lines, as aiohttp's
    ``StreamReader`` does."""

    def __init__(self, resp: "ClientResponse", length: int | None, chunked: bool):
        self._resp = resp
        self._remaining = length
        self._chunked = chunked
        self._chunk_left = 0
        self.at_eof = length == 0
        #: bytes read past the last line ``readline`` returned
        self._pending = b""

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            out = bytearray()
            while chunk := await self.read(_READ_BYTES):
                out += chunk
            return bytes(out)
        if self._pending:
            out, self._pending = self._pending[:n], self._pending[n:]
            return out
        if self.at_eof:
            return b""
        conn, dl = self._resp._conn, self._resp._deadline
        reader = conn.reader
        try:
            if self._chunked:
                if self._chunk_left == 0:
                    line = await dl.io(reader.readuntil(b"\r\n"))
                    try:
                        self._chunk_left = int(line.split(b";", 1)[0].strip(), 16)
                    except ValueError:
                        raise ClientPayloadError(f"bad chunk size line {line[:40]!r}") from None
                    if self._chunk_left == 0:
                        while await dl.io(reader.readuntil(b"\r\n")) != b"\r\n":
                            pass  # trailer fields, ignored
                        return self._finish()
                data = await dl.io(reader.read(min(n, self._chunk_left)))
                if not data:
                    raise ServerDisconnectedError("the server closed the connection mid-chunk")
                self._chunk_left -= len(data)
                if self._chunk_left == 0:
                    await dl.io(reader.readexactly(2))
                return data
            if self._remaining is None:  # read to the connection's end
                data = await dl.io(reader.read(n))
                if not data:
                    return self._finish(reuse=False)
                return data
            data = await dl.io(reader.read(min(n, self._remaining)))
            if not data:
                raise ServerDisconnectedError(
                    f"the server closed the connection {self._remaining} bytes short")
            self._remaining -= len(data)
            if self._remaining == 0:
                self._finish()
            return data
        except asyncio.IncompleteReadError:
            raise ServerDisconnectedError("the server closed the connection mid-body") from None
        except (asyncio.LimitOverrunError, ValueError) as exc:
            raise ClientPayloadError(str(exc)) from None

    def _finish(self, reuse: bool = True) -> bytes:
        self.at_eof = True
        self._resp._body_done(reuse)
        return b""

    async def iter_chunked(self, n: int) -> AsyncIterator[bytes]:
        while chunk := await self.read(n):
            yield chunk

    async def readline(self) -> bytes:
        buf = bytearray()
        while True:
            chunk = await self.read(_READ_BYTES)
            if not chunk:
                return bytes(buf)
            end = chunk.find(b"\n")
            if end >= 0:
                buf += chunk[:end + 1]
                self._pending = chunk[end + 1:] + self._pending
                return bytes(buf)
            buf += chunk

    async def _lines(self) -> AsyncIterator[bytes]:
        while line := await self.readline():
            yield line

    def __aiter__(self) -> AsyncIterator[bytes]:
        return self._lines()


class ClientResponse:
    def __init__(self, session: "ClientSession", conn: _Conn, method: str, url: str,
                 status: int, reason: str, headers: CIDict, deadline: _Deadline,
                 keep_alive: bool):
        self._session = session
        self._conn: _Conn | None = conn
        self._deadline = deadline
        self._keep_alive = keep_alive
        self.method = method
        self.url = url
        self.status = status
        self.reason = reason
        self.headers = headers
        self._body: bytes | None = None
        no_body = method == "HEAD" or status in (204, 304) or 100 <= status < 200
        chunked = "chunked" in headers.get("Transfer-Encoding", "").lower()
        length = None
        if no_body:
            length = 0
        elif not chunked and "Content-Length" in headers:
            try:
                length = int(headers["Content-Length"])
            except ValueError:
                raise ClientPayloadError(
                    f"bad Content-Length {headers['Content-Length']!r}") from None
        if length is None and not chunked:
            self._keep_alive = False
        self.content = StreamReader(self, length, chunked and not no_body)
        if self.content.at_eof and status != 101:  # a 101's socket is the caller's
            self._body_done(True)

    def _body_done(self, reuse: bool) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            self._session._release(conn, reuse and self._keep_alive)

    async def read(self) -> bytes:
        if self._body is None:
            self._body = await self.content.read()
        return self._body

    async def text(self, encoding: str = "utf-8") -> str:
        return (await self.read()).decode(encoding, errors="replace")

    async def json(self, *, loads: Callable[[str], Any] = jsonlib.loads) -> Any:
        raw = await self.read()
        try:
            return loads(raw.decode("utf-8")) if raw.strip() else None
        except ValueError:
            raise ContentTypeError(
                self.status, f"response body is not JSON: {raw[:200]!r}") from None

    def raise_for_status(self) -> None:
        if self.status >= 400:
            self.release()
            raise ClientResponseError(self.status, self.reason)

    def release(self) -> None:
        """Give the connection back: to the pool when the body was read to
        its end, else closed (an unread body is not drained)."""
        conn, self._conn = self._conn, None
        if conn is not None:
            self._session._release(conn, False)


class _RequestContext:
    """What ``session.request`` returns: awaited, the response; used with
    ``async with``, the response, released on exit."""

    def __init__(self, coro):
        self._coro = coro
        self._resp: ClientResponse | None = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.release()


class ClientWebSocketResponse(WebSocketConnection):
    """The client's end of a WebSocket (``aiohttp.ClientWebSocketResponse``):
    its frames are masked."""

    _masks = True


def _split(url: str) -> tuple[tuple, str, str]:
    parts = urlsplit(url)
    scheme = parts.scheme.lower()
    if scheme not in ("http", "https", "ws", "wss"):
        raise ValueError(f"unsupported URL scheme in {url!r}")
    secure = scheme in ("https", "wss")
    host = parts.hostname or ""
    port = parts.port or (443 if secure else 80)
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    default_port = (secure and port == 443) or (not secure and port == 80)
    host_header = (f"[{host}]" if ":" in host else host) + ("" if default_port else f":{port}")
    return (secure, host, port), target, host_header


class ClientSession:
    """Requests over pooled keep-alive connections (``aiohttp.ClientSession``)."""

    def __init__(self, *, timeout: ClientTimeout = DEFAULT_TIMEOUT,
                 headers: dict[str, str] | None = None,
                 ssl_context: ssl.SSLContext | None = None):
        self.timeout = timeout
        self._headers = dict(headers or {})
        #: TLS for ``https`` URLs (default: the system's trust store)
        self._ssl = ssl_context
        self._idle: dict[tuple, list[_Conn]] = {}
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    async def close(self) -> None:
        self._closed = True
        for conns in self._idle.values():
            for conn in conns:
                conn.close()
        self._idle.clear()

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- connections ---------------------------------------------------------

    async def _open(self, key: tuple, deadline: _Deadline) -> _Conn:
        secure, host, port = key
        try:
            reader, writer = await deadline.io(asyncio.open_connection(
                host, port, ssl=(self._ssl or ssl.create_default_context()) if secure else None,
                limit=_BUFFER_BYTES), deadline.timeout.connect)
        except TimeoutError:
            raise
        except OSError as exc:
            raise ClientConnectorError(f"cannot connect to {host}:{port}: {exc}") from exc
        return _Conn(key, reader, writer)

    def _pooled(self, key: tuple) -> _Conn | None:
        conns = self._idle.get(key) or []
        while conns:
            conn = conns.pop()
            if not conn.writer.is_closing() and not conn.reader.at_eof():
                return conn
            conn.close()
        return None

    def _release(self, conn: _Conn, reuse: bool) -> None:
        conns = self._idle.setdefault(conn.key, [])
        if reuse and not self._closed and len(conns) < _POOL_PER_HOST \
                and not conn.writer.is_closing():
            conns.append(conn)
        else:
            conn.close()

    # -- requests ------------------------------------------------------------

    def request(self, method: str, url: str, *, data: Any = None, json: Any = None,
                params: dict[str, str] | None = None, headers: dict[str, str] | None = None,
                timeout: ClientTimeout | None = None) -> _RequestContext:
        return _RequestContext(self._request(method, url, data=data, json=json, params=params,
                                             headers=headers, timeout=timeout))

    def get(self, url: str, **kw) -> _RequestContext:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> _RequestContext:
        return self.request("POST", url, **kw)

    async def _request(self, method: str, url: str, *, data: Any, json: Any,
                       params: dict[str, str] | None, headers: dict[str, str] | None,
                       timeout: ClientTimeout | None) -> ClientResponse:
        if self._closed:
            raise RuntimeError("Session is closed")
        method = method.upper()
        if params:
            url += ("&" if urlsplit(url).query else "?") + urlencode(params)
        key, target, host_header = _split(url)
        hdrs = CIDict(self._headers)
        for k, v in (headers or {}).items():
            hdrs[k] = v
        hdrs.setdefault("Host", host_header)
        hdrs.setdefault("User-Agent", "finetune-controller-tpu-torch")
        hdrs.setdefault("Accept", "*/*")
        body: bytes | None = None
        stream = None
        if json is not None:
            body = jsonlib.dumps(json).encode()
            hdrs.setdefault("Content-Type", "application/json")
        elif isinstance(data, dict):
            body = urlencode(data).encode()
            hdrs.setdefault("Content-Type", "application/x-www-form-urlencoded")
        elif isinstance(data, str):
            body = data.encode()
            hdrs.setdefault("Content-Type", "text/plain; charset=utf-8")
        elif isinstance(data, (bytes, bytearray, memoryview)):
            body = bytes(data)
        elif data is not None:
            stream = data  # an async iterator of bytes: sent chunked
        if stream is not None:
            hdrs["Transfer-Encoding"] = "chunked"
        elif body is not None or method in ("POST", "PUT", "PATCH"):
            hdrs["Content-Length"] = str(len(body or b""))
        head = (f"{method} {target} HTTP/1.1\r\n"
                + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode("latin-1")
        deadline = _Deadline(timeout or self.timeout)
        # a pooled connection may have been closed by the server while idle:
        # a request that fails before any response byte on one is sent again
        # once on a fresh connection, when its body can be sent again
        conn = self._pooled(key) if stream is None else None
        while True:
            fresh = conn is None
            if fresh:
                conn = await self._open(key, deadline)
            try:
                await self._send(conn, head, body, stream, deadline)
                status_line = await deadline.io(conn.reader.readuntil(b"\r\n\r\n"))
                break
            except (asyncio.IncompleteReadError, ConnectionError) as exc:
                conn.close()
                conn = None
                if fresh:
                    raise ServerDisconnectedError(
                        f"{method} {url}: the server closed the connection") from exc
            except BaseException:
                conn.close()
                raise
        try:
            lines = status_line.decode("latin-1").split("\r\n")
            version, code, *reason = lines[0].split(" ", 2)
            status = int(code)
        except ValueError:
            conn.close()
            raise ClientPayloadError(f"bad status line {lines[0][:80]!r}") from None
        resp_headers = CIDict()
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                resp_headers[k.strip()] = v.strip()
        conn_hdr = resp_headers.get("Connection", "").lower()
        keep_alive = conn_hdr != "close" and (version != "HTTP/1.0" or conn_hdr == "keep-alive")
        return ClientResponse(self, conn, method, url, status, reason[0] if reason else "",
                              resp_headers, deadline, keep_alive)

    async def _send(self, conn: _Conn, head: bytes, body: bytes | None, stream,
                    deadline: _Deadline) -> None:
        writer = conn.writer
        if stream is None:
            writer.write(head + (body or b""))
            await deadline.io(writer.drain())
            return
        writer.write(head)
        async for chunk in stream:
            if chunk:
                writer.write(b"%x\r\n" % len(chunk) + bytes(chunk) + b"\r\n")
                await deadline.io(writer.drain())
        writer.write(b"0\r\n\r\n")
        await deadline.io(writer.drain())

    # -- WebSocket -----------------------------------------------------------

    async def ws_connect(self, url: str, *, headers: dict[str, str] | None = None,
                         heartbeat: float | None = None,
                         timeout: float = 30.0) -> ClientWebSocketResponse:
        """Upgrade a GET of ``url`` (``ws://`` or ``http://``) to a
        WebSocket; ``timeout`` bounds the handshake."""
        key = base64.b64encode(os.urandom(16)).decode()
        hdrs = {**(headers or {}), "Upgrade": "websocket", "Connection": "Upgrade",
                "Sec-WebSocket-Version": "13", "Sec-WebSocket-Key": key}
        http_url = "http" + url[2:] if url.startswith("ws") else url
        resp = await self._request("GET", http_url, data=None, json=None, params=None,
                                   headers=hdrs, timeout=ClientTimeout(total=timeout))
        if resp.status != 101:
            text = await resp.text()
            resp.release()
            raise WSServerHandshakeError(resp.status, f"Invalid response status: {text[:200]}")
        conn, resp._conn = resp._conn, None
        if resp.headers.get("Sec-WebSocket-Accept", "") != ws_accept_key(key):
            conn.close()
            raise WSServerHandshakeError(resp.status, "Invalid challenge response")
        ws = ClientWebSocketResponse(heartbeat=heartbeat)
        ws._attach(conn.reader, conn.writer)
        return ws
