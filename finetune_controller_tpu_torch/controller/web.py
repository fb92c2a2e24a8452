"""A small asyncio HTTP/1.1 server offering the part of ``aiohttp.web``
that the control plane's handlers use.

The port adds no third-party dependency to the card machine's image, and
``aiohttp`` is not one it may import (``tests/test_torch_import.py``), so
its handlers (``controller/server.py``, ``serve/service.py``) are written
against this module instead.  That rule, not a missing package, is the
module's only reason: once the port may import ``aiohttp``, the handlers
run on ``aiohttp.web`` unchanged and this module goes.  The names follow
``aiohttp.web`` so the handlers read as the reference's do:

* :class:`Application` — ``router.add_get/add_post/add_delete``,
  middlewares (``async def mw(request, handler)``), app keys
  (:class:`AppKey`), ``on_startup``/``on_cleanup``;
* :class:`Request` — ``match_info``, ``query``, ``headers``, ``cookies``,
  ``json()``, ``read()``, ``multipart()``, ``content_type``,
  ``can_read_body``, ``remote``, and item storage (``request["user"]``);
* :class:`Response`, :func:`json_response`, :class:`StreamResponse` (a
  chunked or sized streamed body) and the ``HTTP*`` exceptions, which are
  responses that a handler raises;
* :class:`WebSocketResponse` — a server-side WebSocket (RFC 6455) in the
  shape of ``aiohttp.web.WebSocketResponse``: ``prepare``, ``send_str``,
  ``send_bytes``, ``receive``, ``ping``, ``close``, ``closed``, a
  ``heartbeat`` that closes a peer which stops answering pings (pings are
  answered, pongs taken, never queued);
* :class:`AppRunner` + :class:`TCPSite` and :func:`run_app` to serve an
  application on ``asyncio.start_server``.  Stopping a site sends every
  open WebSocket a 1001 close frame and closes every connection's writer
  before it waits for the listener to close.

Only what the handlers need is here: no HTTP/2, no compression, no
WebSocket extensions or subprotocols.  A body stays on the socket until
the handler reads it:
``read()``/``json()`` take it whole, up to ``client_max_size``, while
``multipart()`` streams it field by field with no size limit, so a dataset
upload is never held in memory whole.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import enum
import hashlib
import json
import logging
import os
import re
import signal
from collections.abc import MutableMapping
from http import HTTPStatus
from http.cookies import SimpleCookie
from typing import Any, Awaitable, Callable, Iterator, NamedTuple
from urllib.parse import parse_qsl, unquote, urlsplit

logger = logging.getLogger(__name__)

Handler = Callable[["Request"], Awaitable["StreamResponse"]]

#: longest request head (request line + headers) accepted
_MAX_HEAD_BYTES = 64 * 1024
#: most bytes taken from the socket by one read of a request body
_READ_BYTES = 64 * 1024
#: seconds an idle connection waits for its next request head
#: (aiohttp's ``keepalive_timeout``)
_KEEPALIVE_S = 75.0
#: seconds spent discarding a body the handler left unread before the
#: connection is closed instead (aiohttp's ``lingering_time``)
_LINGER_S = 10.0
#: seconds a WebSocket's close waits for the peer's close frame (aiohttp's
#: ``timeout``), and a stopping site for each open WebSocket's
_WS_CLOSE_S = 10.0
_WS_SHUTDOWN_S = 1.0


# ---------------------------------------------------------------------------
# Headers and query strings
# ---------------------------------------------------------------------------


class CIDict(MutableMapping):
    """A case-insensitive header mapping that keeps the first-set spelling."""

    def __init__(self, data: Any = None):
        self._items: dict[str, tuple[str, str]] = {}
        if data:
            for k, v in (data.items() if hasattr(data, "items") else data):
                self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._items[key.lower()][1]

    def __setitem__(self, key: str, value: Any) -> None:
        self._items[key.lower()] = (key, str(value))

    def __delitem__(self, key: str) -> None:
        del self._items[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return (k for k, _ in self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._items

    def __repr__(self) -> str:
        return f"CIDict({dict(self.items())!r})"


def _param_value(header: str, name: str) -> str | None:
    """``name=value`` (quoted or bare) from a header like Content-Type or
    Content-Disposition."""
    m = re.search(rf';\s*{re.escape(name)}\s*=\s*("((?:[^"\\]|\\.)*)"|[^;\s]+)',
                  header, re.IGNORECASE)
    if m is None:
        return None
    if m.group(2) is not None:
        return re.sub(r"\\(.)", r"\1", m.group(2))
    return m.group(1)


# ---------------------------------------------------------------------------
# Responses and HTTP exceptions
# ---------------------------------------------------------------------------


class StreamResponse:
    """A response whose body the handler writes after :meth:`prepare`:
    sized when the handler sets ``Content-Length``, chunked otherwise."""

    def __init__(self, *, status: int = 200, reason: str | None = None,
                 headers: Any = None):
        self.status = int(status)
        self.reason = reason or _reason(self.status)
        self.headers = CIDict(headers)
        self._writer: asyncio.StreamWriter | None = None
        self._chunked = False
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    async def prepare(self, request: "Request") -> "StreamResponse":
        if self._writer is not None:
            return self
        self._writer = request._writer
        self._chunked = "Content-Length" not in self.headers
        if self._chunked:
            self.headers["Transfer-Encoding"] = "chunked"
        self._writer.write(_head(self.status, self.reason, self.headers,
                                 request._keep_alive))
        await self._writer.drain()
        return self

    async def write(self, data: bytes) -> None:
        if self._writer is None:
            raise RuntimeError("write() before prepare()")
        if not data:
            return
        if self._chunked:
            self._writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
        else:
            self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self) -> None:
        if self._writer is None or self._eof:
            return
        self._eof = True
        if self._chunked:
            self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


class Response(StreamResponse):
    """A response with its whole body in memory (``body`` bytes or
    ``text``)."""

    def __init__(self, *, body: bytes | None = None, status: int = 200,
                 reason: str | None = None, text: str | None = None,
                 headers: Any = None, content_type: str | None = None,
                 charset: str | None = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        if text is not None:
            charset = charset or "utf-8"
            body = text.encode(charset)
            if "Content-Type" not in self.headers:
                self.headers["Content-Type"] = (
                    f"{content_type or 'text/plain'}; charset={charset}")
        elif content_type is not None:
            self.headers["Content-Type"] = (
                f"{content_type}; charset={charset}" if charset else content_type)
        elif body is not None and "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"
        self.body = body if body is not None else b""

    async def _send(self, request: "Request") -> None:
        if request.method == "HEAD":  # the headers a GET would send, no body
            self.headers.setdefault("Content-Length", str(len(self.body)))
            request._writer.write(_head(self.status, self.reason, self.headers,
                                        request._keep_alive))
        else:
            self.headers["Content-Length"] = str(len(self.body))
            request._writer.write(_head(self.status, self.reason, self.headers,
                                        request._keep_alive) + self.body)
        await request._writer.drain()


def json_response(data: Any = None, *, text: str | None = None, body: bytes | None = None,
                  status: int = 200, reason: str | None = None, headers: Any = None,
                  content_type: str = "application/json",
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    if data is not None:
        if text or body:
            raise ValueError("only one of data, text, or body should be specified")
        text = dumps(data)
    return Response(text=text, body=body, status=status, reason=reason,
                    headers=headers, content_type=content_type)


class HTTPException(Response, Exception):
    """A response raised by a handler (``aiohttp.web.HTTPException``)."""

    status_code = 500

    def __init__(self, *, headers: Any = None, reason: str | None = None,
                 text: str | None = None, content_type: str | None = None,
                 body: bytes | None = None):
        reason = reason or _reason(self.status_code)
        if body is None and text is None:
            text = f"{self.status_code}: {reason}"
        Response.__init__(self, status=self.status_code, headers=headers,
                          reason=reason, text=text, body=body,
                          content_type=content_type)
        Exception.__init__(self, reason)

    def __str__(self) -> str:
        return self.reason


def _http_error(name: str, code: int) -> type[HTTPException]:
    return type(name, (HTTPException,), {"status_code": code})


HTTPBadRequest = _http_error("HTTPBadRequest", 400)
HTTPUnauthorized = _http_error("HTTPUnauthorized", 401)
HTTPForbidden = _http_error("HTTPForbidden", 403)
HTTPNotFound = _http_error("HTTPNotFound", 404)
HTTPMethodNotAllowed = _http_error("HTTPMethodNotAllowed", 405)
HTTPRequestEntityTooLarge = _http_error("HTTPRequestEntityTooLarge", 413)
HTTPTooManyRequests = _http_error("HTTPTooManyRequests", 429)


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return ""


def _head(status: int, reason: str, headers: CIDict, keep_alive: bool) -> bytes:
    headers.setdefault("Connection", "keep-alive" if keep_alive else "close")
    lines = [f"HTTP/1.1 {status} {reason}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


# ---------------------------------------------------------------------------
# Requests and multipart bodies
# ---------------------------------------------------------------------------


class _Payload:
    """A request body, read from the socket only as the handler asks for
    it: sized (``Content-Length``) or chunked (``length=None``)."""

    def __init__(self, reader: asyncio.StreamReader, length: int | None):
        self._reader = reader
        self._remaining = length  # bytes left of a sized body
        self._chunk_left = 0  # bytes left of the current chunk
        self.at_eof = length == 0

    async def readany(self, n: int = _READ_BYTES) -> bytes:
        """Up to ``n`` bytes of the body; ``b""`` at its end."""
        if self.at_eof:
            return b""
        try:
            if self._remaining is not None:
                data = await self._reader.read(min(n, self._remaining))
                if not data:
                    raise asyncio.IncompleteReadError(b"", self._remaining)
                self._remaining -= len(data)
                self.at_eof = self._remaining == 0
                return data
            if self._chunk_left == 0:
                size_line = await self._reader.readuntil(b"\r\n")
                try:
                    self._chunk_left = int(size_line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise HTTPBadRequest(text="invalid chunk size line") from None
                if self._chunk_left == 0:
                    while await self._reader.readuntil(b"\r\n") != b"\r\n":
                        pass  # trailer fields, ignored
                    self.at_eof = True
                    return b""
            data = await self._reader.read(min(n, self._chunk_left))
            if not data:
                raise asyncio.IncompleteReadError(b"", self._chunk_left)
            self._chunk_left -= len(data)
            if self._chunk_left == 0:
                await self._reader.readexactly(2)  # the chunk's CRLF
            return data
        except asyncio.IncompleteReadError:
            raise ConnectionResetError("client closed the connection mid-body") from None

    async def drain(self, timeout: float) -> bool:
        """Discard what the handler left unread; False if that took longer
        than ``timeout`` seconds (the connection is then closed)."""
        try:
            async with asyncio.timeout(timeout):
                while await self.readany():
                    pass
        except TimeoutError:
            return False
        return True


class BodyPartReader:
    """One field of a ``multipart/form-data`` body, read from the socket
    chunk by chunk (``read_chunk``) or whole (``read``)."""

    def __init__(self, headers: CIDict, multipart: "MultipartReader"):
        self.headers = headers
        self._mp = multipart
        self.at_eof = False
        disposition = headers.get("Content-Disposition", "")
        self.name = _param_value(disposition, "name")
        self.filename = _param_value(disposition, "filename")

    async def read_chunk(self, size: int = 8192) -> bytes:
        """Up to ``size`` bytes of the field; ``b""`` at its end."""
        if self.at_eof:
            return b""
        mp = self._mp
        end = b"\r\n" + mp.delim
        while True:
            idx = mp.buf.find(end)
            if idx >= 0:
                n = min(size, idx)
                chunk = bytes(mp.buf[:n])
                if n == idx:  # the field ends here: drop the delimiter too
                    del mp.buf[:idx + len(end)]
                    self.at_eof = True
                else:
                    del mp.buf[:n]
                if chunk or self.at_eof:
                    return chunk
                continue
            # the tail may hold the start of the delimiter: keep it back
            safe = len(mp.buf) - (len(end) - 1)
            if safe > 0:
                n = min(size, safe)
                chunk = bytes(mp.buf[:n])
                del mp.buf[:n]
                return chunk
            if not await mp.fill():
                raise HTTPBadRequest(text="truncated multipart body")

    async def read(self, *, decode: bool = False) -> bytes:
        """The rest of the field (``decode`` is accepted for parity; no
        transfer encoding is applied to form fields here)."""
        out = bytearray()
        while chunk := await self.read_chunk(_READ_BYTES):
            out += chunk
        return bytes(out)

    async def release(self) -> None:
        """Skip the rest of the field."""
        while await self.read_chunk(_READ_BYTES):
            pass


class MultipartReader:
    """The fields of a ``multipart/form-data`` body, in order
    (``async for part in await request.multipart()``), parsed as the body
    arrives: at most one read of the socket plus a delimiter's length is
    held in memory, and a field left unread is skipped."""

    def __init__(self, content_type: str, payload: _Payload):
        boundary = _param_value(content_type, "boundary")
        if not boundary:
            raise HTTPBadRequest(text="multipart body without a boundary")
        self.delim = b"--" + boundary.encode("latin-1")
        self.buf = bytearray()
        self._payload = payload
        self._part: BodyPartReader | None = None
        self._started = False
        self._done = False

    async def fill(self) -> bool:
        """Append the next read of the body to the buffer; False at its end."""
        data = await self._payload.readany()
        self.buf += data
        return bool(data)

    def __aiter__(self):
        return self

    async def __anext__(self) -> BodyPartReader:
        if self._part is not None:
            await self._part.release()
            self._part = None
        if self._done:
            raise StopAsyncIteration
        if not self._started:  # skip the preamble up to the first delimiter
            while (idx := self.buf.find(self.delim)) < 0:
                del self.buf[:max(0, len(self.buf) - len(self.delim) + 1)]
                if not await self.fill():
                    raise HTTPBadRequest(text="multipart body holds no boundary line")
            del self.buf[:idx + len(self.delim)]
            self._started = True
        # the buffer now starts just after a delimiter
        while len(self.buf) < 2:
            if not await self.fill():
                raise HTTPBadRequest(text="truncated multipart body")
        if self.buf[:2] == b"--":  # the closing delimiter
            self._done = True
            raise StopAsyncIteration
        while (head_end := self.buf.find(b"\r\n\r\n")) < 0:
            if len(self.buf) > _MAX_HEAD_BYTES:
                raise HTTPBadRequest(text="multipart part headers too long")
            if not await self.fill():
                raise HTTPBadRequest(text="truncated multipart part headers")
        headers = CIDict()
        for line in self.buf[:head_end].decode("utf-8", "replace").split("\r\n"):
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip()] = v.strip()
        del self.buf[:head_end + 4]
        self._part = BodyPartReader(headers, self)
        return self._part


class Request(MutableMapping):
    """One parsed HTTP request (``aiohttp.web.Request``).  The body stays
    on the socket until the handler reads it: :meth:`read` (and ``text``,
    ``json``) take it whole, up to the app's ``client_max_size``;
    :meth:`multipart` streams it with no such limit, as aiohttp does."""

    def __init__(self, app: "Application", method: str, target: str,
                 version: str, headers: CIDict, payload: _Payload, *,
                 remote: str | None, writer: asyncio.StreamWriter,
                 keep_alive: bool):
        self.app = app
        self.method = method.upper()
        self.version = version
        self.headers = headers
        self.remote = remote
        self.match_info: dict[str, str] = {}
        parts = urlsplit(target)
        self.raw_path = target
        self.path = unquote(parts.path)
        self.query_string = parts.query
        # the first value of a repeated key, as aiohttp's ``query.get``
        self.query: dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(k, v)
        self._payload = payload
        self._read_bytes: bytes | None = None
        self._writer = writer
        self._keep_alive = keep_alive
        #: the connection was handed to a WebSocket (:class:`WebSocketResponse`)
        self._upgraded = False
        self._state: dict[str, Any] = {}

    # item storage: middlewares hand values to handlers (request["user"])
    def __getitem__(self, key: str) -> Any:
        return self._state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._state[key] = value

    def __delitem__(self, key: str) -> None:
        del self._state[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)

    @property
    def content_type(self) -> str:
        raw = self.headers.get("Content-Type", "application/octet-stream")
        return raw.split(";", 1)[0].strip().lower()

    @property
    def charset(self) -> str | None:
        return _param_value(self.headers.get("Content-Type", ""), "charset")

    @property
    def cookies(self) -> dict[str, str]:
        jar = SimpleCookie()
        with contextlib.suppress(Exception):
            jar.load(self.headers.get("Cookie", ""))
        return {k: m.value for k, m in jar.items()}

    @property
    def can_read_body(self) -> bool:
        return not self._payload.at_eof

    async def read(self) -> bytes:
        if self._read_bytes is None:
            limit = self.app.client_max_size
            chunks, size = [], 0
            while chunk := await self._payload.readany():
                chunks.append(chunk)
                size += len(chunk)
                if size > limit:
                    raise HTTPRequestEntityTooLarge(
                        text=f"Maximum request body size {limit} exceeded, "
                             f"actual body size {size}")
            self._read_bytes = b"".join(chunks)  # one copy of a large body
        return self._read_bytes

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self, *, loads: Callable[[str], Any] = json.loads) -> Any:
        return loads(await self.text())

    async def multipart(self) -> MultipartReader:
        return MultipartReader(self.headers.get("Content-Type", ""), self._payload)


# ---------------------------------------------------------------------------
# Routing and the application
# ---------------------------------------------------------------------------


class AppKey:
    """A typed key for :class:`Application` storage (``aiohttp.web.AppKey``)."""

    def __init__(self, name: str, t: Any = object):
        self.name = name
        self.type = t

    def __repr__(self) -> str:
        return f"<AppKey({self.name})>"


class Resource:
    """A route's path: ``/a/{name}/b`` matches one segment per ``{name}``;
    ``{name:regex}`` matches the regex (``{tail:.*}`` the rest of the
    path), as aiohttp's routes do."""

    def __init__(self, path: str):
        self.path = path
        self.dynamic = "{" in path
        pattern, pos = "", 0
        for m in re.finditer(r"\{(\w+)(?::([^{}]+))?\}", path):
            pattern += re.escape(path[pos:m.start()])
            pattern += f"(?P<{m.group(1)}>{m.group(2) or '[^/]+'})"
            pos = m.end()
        pattern += re.escape(path[pos:])
        self._re = re.compile(f"^{pattern}$")

    def match(self, path: str) -> dict[str, str] | None:
        m = self._re.match(path)
        return None if m is None else m.groupdict()

    def get_info(self) -> dict[str, str]:
        return {"formatter": self.path} if self.dynamic else {"path": self.path}


class Route:
    def __init__(self, method: str, resource: Resource, handler: Handler):
        self.method = method
        self.resource = resource
        self.handler = handler


class Router:
    def __init__(self):
        self._routes: list[Route] = []

    def add_route(self, method: str, path: str, handler: Handler) -> Route:
        route = Route(method.upper(), Resource(path), handler)
        self._routes.append(route)
        return route

    def add_get(self, path: str, handler: Handler) -> Route:
        return self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> Route:
        return self.add_route("POST", path, handler)

    def add_delete(self, path: str, handler: Handler) -> Route:
        return self.add_route("DELETE", path, handler)

    def routes(self) -> list[Route]:
        return list(self._routes)

    def resolve(self, method: str, path: str) -> tuple[Handler, dict[str, str]]:
        """The handler and path parameters for a request; a handler that
        raises 404 (no path matches) or 405 (no method matches) otherwise."""
        allowed = False
        for route in self._routes:
            params = route.resource.match(path)
            if params is None:
                continue
            if route.method == method:
                return route.handler, params
            allowed = True
        error = HTTPMethodNotAllowed if allowed else HTTPNotFound

        async def refuse(request: Request) -> StreamResponse:
            raise error()

        return refuse, {}


def middleware(fn):
    """Marks a new-style middleware (kept for parity; every middleware here
    is ``async def mw(request, handler)``)."""
    fn.__middleware_version__ = 1
    return fn


class Application(MutableMapping):
    """Routes, middlewares and app-key storage (``aiohttp.web.Application``)."""

    def __init__(self, *, middlewares: Any = (), client_max_size: int = 1024 ** 2):
        self.router = Router()
        self.middlewares = list(middlewares)
        self.client_max_size = client_max_size
        self.on_startup: list[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["Application"], Awaitable[None]]] = []
        self._state: dict[Any, Any] = {}
        #: open server-side WebSockets, closed with 1001 when a site stops
        self._websockets: set[WebSocketResponse] = set()

    def __getitem__(self, key: Any) -> Any:
        return self._state[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        self._state[key] = value

    def __delitem__(self, key: Any) -> None:
        del self._state[key]

    def __iter__(self):
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)

    async def startup(self) -> None:
        for cb in self.on_startup:
            await cb(self)

    async def cleanup(self) -> None:
        for cb in reversed(self.on_cleanup):
            await cb(self)

    async def handle(self, request: Request) -> StreamResponse:
        """Route ``request`` through the middlewares (the first listed is
        the outermost) to its handler."""
        handler, params = self.router.resolve(request.method, request.path)
        request.match_info = params
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        return await handler(request)


def _bind(mw, inner: Handler) -> Handler:
    async def call(request: Request) -> StreamResponse:
        return await mw(request, inner)

    return call


# ---------------------------------------------------------------------------
# WebSocket (RFC 6455)
# ---------------------------------------------------------------------------

#: the GUID RFC 6455 §1.3 appends to the client's ``Sec-WebSocket-Key``
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
#: largest message accepted, reassembled fragments included (aiohttp's
#: default ``max_msg_size``)
WS_MAX_MSG_SIZE = 4 * 1024 * 1024


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    PING = 0x9
    PONG = 0xA
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    NO_STATUS = 1005
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    MESSAGE_TOO_BIG = 1009


class WSMessage(NamedTuple):
    """One message: ``data`` is the text, the bytes, the close code or the
    exception; ``extra`` the close reason."""

    type: WSMsgType
    data: Any
    extra: Any


_WS_CLOSED_MESSAGE = WSMessage(WSMsgType.CLOSED, None, None)


class _WSProtocolError(Exception):
    def __init__(self, code: WSCloseCode, message: str):
        super().__init__(message)
        self.code = code


def ws_accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client key: base64 of the SHA-1 of the
    key followed by :data:`WS_GUID`."""
    return base64.b64encode(hashlib.sha1((key + WS_GUID).encode()).digest()).decode()


def _ws_mask(data: bytes, key: bytes) -> bytes:
    """XOR ``data`` with the 4-byte ``key`` repeated (masking is its own
    inverse), as one big-integer XOR."""
    n = len(data)
    if not n:
        return b""
    pad = (key * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little") ^ int.from_bytes(pad, "little")).to_bytes(n, "little")


def ws_frame(opcode: int, payload: bytes, *, mask: bool) -> bytes:
    """One final frame: 7-bit, 16-bit or 64-bit length; a client masks its
    frames with a fresh key, a server never does."""
    n = len(payload)
    head = bytearray([0x80 | opcode])
    bit = 0x80 if mask else 0
    if n < 126:
        head.append(bit | n)
    elif n < 1 << 16:
        head.append(bit | 126)
        head += n.to_bytes(2, "big")
    else:
        head.append(bit | 127)
        head += n.to_bytes(8, "big")
    if mask:
        key = os.urandom(4)
        head += key
        payload = _ws_mask(payload, key)
    return bytes(head) + payload


class WebSocketConnection:
    """The frame loop a WebSocket's two ends share, once the handshake is
    done: a reader task that answers pings, reassembles fragmented
    messages and queues whole messages for :meth:`receive`; the close
    handshake; and a heartbeat that pings a peer silent for ``heartbeat``
    seconds and, when nothing comes back within half of that, closes the
    connection (close code 1006), as aiohttp's does."""

    #: the client masks what it sends and the server expects masked frames
    _masks = False

    def __init__(self, *, heartbeat: float | None = None):
        self._heartbeat = heartbeat
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._queue: asyncio.Queue | None = None
        self._tasks: list[asyncio.Task] = []
        self._closed = False
        self._close_sent = False
        self._close_code: int | None = None
        self._last_heard = 0.0

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def close_code(self) -> int | None:
        return self._close_code

    def _attach(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        self._reader, self._writer = reader, writer
        self._queue = asyncio.Queue()
        self._last_heard = loop.time()
        self._tasks.append(loop.create_task(self._read_loop()))
        if self._heartbeat:
            self._tasks.append(loop.create_task(self._heartbeat_loop()))

    # -- sending -------------------------------------------------------------

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self._writer is None:
            raise RuntimeError("the WebSocket is not prepared")
        if self._close_sent or self._writer.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        self._writer.write(ws_frame(opcode, payload, mask=self._masks))
        await self._writer.drain()

    async def send_str(self, data: str) -> None:
        if not isinstance(data, str):
            raise TypeError(f"data argument must be str ({type(data)!r})")
        await self._send_frame(WSMsgType.TEXT, data.encode("utf-8"))

    async def send_bytes(self, data: bytes) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"data argument must be byte-ish ({type(data)!r})")
        await self._send_frame(WSMsgType.BINARY, bytes(data))

    async def ping(self, message: bytes = b"") -> None:
        await self._send_frame(WSMsgType.PING, bytes(message))

    async def pong(self, message: bytes = b"") -> None:
        await self._send_frame(WSMsgType.PONG, bytes(message))

    # -- receiving -----------------------------------------------------------

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        read = self._reader.readexactly
        b0, b1 = await read(2)
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if b0 & 0x70:
            raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, "reserved bits set")
        if masked == self._masks:
            raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR,
                                   "masked server frame" if masked else "unmasked client frame")
        if n == 126:
            n = int.from_bytes(await read(2), "big")
        elif n == 127:
            n = int.from_bytes(await read(8), "big")
        if opcode >= 0x8 and (not fin or n > 125):
            raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, "bad control frame")
        if n > WS_MAX_MSG_SIZE:
            raise _WSProtocolError(WSCloseCode.MESSAGE_TOO_BIG,
                                   f"message of {n} bytes exceeds {WS_MAX_MSG_SIZE}")
        key = await read(4) if masked else b""
        payload = await read(n)
        return fin, opcode, _ws_mask(payload, key) if masked else payload

    def _message(self, opcode: int, payload: bytes) -> WSMessage:
        if opcode == WSMsgType.BINARY:
            return WSMessage(WSMsgType.BINARY, payload, "")
        try:
            return WSMessage(WSMsgType.TEXT, payload.decode("utf-8"), "")
        except UnicodeDecodeError:
            raise _WSProtocolError(WSCloseCode.INVALID_TEXT, "invalid UTF-8 text") from None

    async def _read_loop(self) -> None:
        parts: list[bytes] = []
        kind = 0  # the opcode of the message being reassembled
        try:
            while True:
                fin, opcode, payload = await self._read_frame()
                self._last_heard = asyncio.get_running_loop().time()
                if opcode == WSMsgType.CLOSE:
                    code = (int.from_bytes(payload[:2], "big") if len(payload) >= 2
                            else WSCloseCode.NO_STATUS)
                    reason = payload[2:].decode("utf-8", "replace")
                    await self._peer_closed(code)
                    self._queue.put_nowait(WSMessage(WSMsgType.CLOSE, code, reason))
                    return
                if opcode == WSMsgType.PING:
                    with contextlib.suppress(ConnectionError, RuntimeError):
                        await self.pong(payload)
                elif opcode == WSMsgType.PONG:
                    pass  # heard: the heartbeat reads ``_last_heard``
                elif opcode in (WSMsgType.TEXT, WSMsgType.BINARY):
                    if kind:
                        raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR,
                                               "a new message inside a fragmented one")
                    if fin:
                        self._queue.put_nowait(self._message(opcode, payload))
                    else:
                        kind, parts = opcode, [payload]
                elif opcode == WSMsgType.CONTINUATION:
                    if not kind:
                        raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR,
                                               "a continuation frame with no message")
                    parts.append(payload)
                    if sum(map(len, parts)) > WS_MAX_MSG_SIZE:
                        raise _WSProtocolError(WSCloseCode.MESSAGE_TOO_BIG,
                                               f"message exceeds {WS_MAX_MSG_SIZE} bytes")
                    if fin:
                        self._queue.put_nowait(self._message(kind, b"".join(parts)))
                        kind, parts = 0, []
                else:
                    raise _WSProtocolError(WSCloseCode.PROTOCOL_ERROR, f"opcode {opcode:#x}")
        except _WSProtocolError as exc:
            self._queue.put_nowait(WSMessage(WSMsgType.ERROR, exc, None))
            await self._fail(exc.code)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            # the peer went away without a close frame
            if not self._closed:
                self._queue.put_nowait(WSMessage(WSMsgType.ERROR, exc, None))
            self._abort(WSCloseCode.ABNORMAL_CLOSURE)

    async def _peer_closed(self, code: int) -> None:
        """The peer's close frame: answer it (unless ours went first), then
        close the transport."""
        if not self._close_sent:
            with contextlib.suppress(ConnectionError, RuntimeError):
                self._writer.write(ws_frame(WSMsgType.CLOSE, int(
                    code if code != WSCloseCode.NO_STATUS else WSCloseCode.OK).to_bytes(2, "big"),
                    mask=self._masks))
                await self._writer.drain()
            self._close_sent = True
        if self._close_code is None:
            self._close_code = code
        self._closed = True
        self._stop_heartbeat()
        if not self._masks:  # the server closes the TCP connection first
            self._writer.close()

    async def _fail(self, code: WSCloseCode) -> None:
        """Close with ``code`` after a protocol fault."""
        if not self._close_sent:
            with contextlib.suppress(ConnectionError, RuntimeError):
                self._writer.write(ws_frame(WSMsgType.CLOSE, int(code).to_bytes(2, "big"),
                                            mask=self._masks))
                await self._writer.drain()
            self._close_sent = True
        self._abort(code)

    def _abort(self, code: int) -> None:
        self._closed = True
        if self._close_code is None:
            self._close_code = code
        self._stop_heartbeat()
        if self._writer is not None:
            self._writer.close()

    def _stop_heartbeat(self) -> None:
        for task in self._tasks[1:]:
            if task is not asyncio.current_task():
                task.cancel()

    async def _heartbeat_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            idle = loop.time() - self._last_heard
            if idle < self._heartbeat:
                await asyncio.sleep(self._heartbeat - idle)
                continue
            pinged = loop.time()
            try:
                await self.ping()
            except (ConnectionError, RuntimeError):
                return
            await asyncio.sleep(self._heartbeat / 2)
            if self._last_heard < pinged and not self._closed:
                exc = TimeoutError(f"No PONG received after {self._heartbeat / 2} seconds")
                self._queue.put_nowait(WSMessage(WSMsgType.ERROR, exc, None))
                self._abort(WSCloseCode.ABNORMAL_CLOSURE)
                return

    async def receive(self, timeout: float | None = None) -> WSMessage:
        """The next message; once the connection is closed and every queued
        message was taken, a ``CLOSED`` message."""
        if self._queue is None:
            raise RuntimeError("the WebSocket is not prepared")
        if self._queue.empty() and (self._closed or self._tasks[0].done()):
            return _WS_CLOSED_MESSAGE
        get = asyncio.ensure_future(self._queue.get())
        try:
            done, _ = await asyncio.wait({get, self._tasks[0]}, timeout=timeout,
                                        return_when=asyncio.FIRST_COMPLETED)
        finally:
            if not get.done():
                get.cancel()
        if get in done:
            return get.result()
        if not done:
            raise TimeoutError(f"no WebSocket message within {timeout} s")
        return self._queue.get_nowait() if not self._queue.empty() else _WS_CLOSED_MESSAGE

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"",
                    timeout: float | None = None) -> bool:
        """Send a close frame, wait (at most ``timeout`` s, 10 by default) for
        the peer's, close the transport.  False when already closed."""
        if self._writer is None or self._closed:
            if self._writer is not None:
                self._writer.close()
            return False
        self._closed = True
        self._close_code = code
        self._stop_heartbeat()
        if not self._close_sent:
            self._close_sent = True
            try:
                self._writer.write(ws_frame(WSMsgType.CLOSE, int(code).to_bytes(2, "big")
                                            + bytes(message), mask=self._masks))
                await self._writer.drain()
            except (ConnectionError, RuntimeError):
                self._writer.close()
                return True
        reader = self._tasks[0]
        if not reader.done():
            try:
                await asyncio.wait_for(asyncio.shield(reader), timeout or _WS_CLOSE_S)
            except TimeoutError:
                reader.cancel()
                self._close_code = WSCloseCode.ABNORMAL_CLOSURE
        self._writer.close()
        return True


class WebSocketResponse(WebSocketConnection):
    """The server's end (``aiohttp.web.WebSocketResponse``): :meth:`prepare`
    validates the upgrade request, raising 400 before anything is written,
    and answers 101 with ``Sec-WebSocket-Accept``; the connection then
    belongs to this object until it closes.  The application tracks it so
    that a stopping site can close it with 1001."""

    def __init__(self, *, heartbeat: float | None = None):
        super().__init__(heartbeat=heartbeat)
        self.status = 101
        self._app: "Application | None" = None
        self._task: asyncio.Task | None = None  # the connection's handler

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    async def prepare(self, request: "Request") -> "WebSocketResponse":
        if self._writer is not None:
            return self
        headers = request.headers
        if headers.get("Upgrade", "").lower().strip() != "websocket":
            raise HTTPBadRequest(text=f"No WebSocket UPGRADE hdr: {headers.get('Upgrade')}\n "
                                      'Can "Upgrade" only to "WebSocket".')
        if "upgrade" not in headers.get("Connection", "").lower():
            raise HTTPBadRequest(text=f"No CONNECTION upgrade hdr: {headers.get('Connection')}")
        if headers.get("Sec-WebSocket-Version", "") not in ("13", "8", "7"):
            raise HTTPBadRequest(
                text=f"Unsupported version: {headers.get('Sec-WebSocket-Version')}")
        key = headers.get("Sec-WebSocket-Key", "")
        try:
            valid = len(base64.b64decode(key, validate=True)) == 16
        except ValueError:
            valid = False
        if not valid:
            raise HTTPBadRequest(text=f"Handshake error: {key!r}")
        request._keep_alive = False
        request._upgraded = True
        writer = request._writer
        writer.write(_head(101, _reason(101), CIDict({
            "Upgrade": "websocket", "Connection": "upgrade",
            "Sec-WebSocket-Accept": ws_accept_key(key)}), False))
        await writer.drain()
        self._app = request.app
        self._task = asyncio.current_task()
        request.app._websockets.add(self)
        self._attach(request._payload._reader, writer)
        return self

    async def close(self, *, code: int = WSCloseCode.OK, message: bytes = b"",
                    timeout: float | None = None) -> bool:
        try:
            return await super().close(code=code, message=message, timeout=timeout)
        finally:
            if self._app is not None:
                self._app._websockets.discard(self)

    async def write_eof(self) -> None:
        """The handler returned: close the WebSocket if it is still open."""
        await self.close()


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


def _payload_for(reader: asyncio.StreamReader, headers: CIDict) -> _Payload:
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        return _Payload(reader, None)
    raw = headers.get("Content-Length", "0").strip() or "0"
    if not raw.isdigit():
        raise HTTPBadRequest(text=f"invalid Content-Length {raw!r}")
    return _Payload(reader, int(raw))


async def _serve_connection(app: Application, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
    peer = writer.get_extra_info("peername")
    remote = peer[0] if isinstance(peer, tuple) else None
    try:
        while True:
            try:
                head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                              _KEEPALIVE_S)
            except (asyncio.IncompleteReadError, ConnectionError, TimeoutError):
                return
            except asyncio.LimitOverrunError:
                writer.write(_head(431, _reason(431), CIDict(), False))
                return
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, target, version = lines[0].split(" ", 2)
            except ValueError:
                writer.write(_head(400, _reason(400), CIDict(), False))
                return
            headers = CIDict()
            for line in lines[1:]:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip()] = v.strip()
            conn = headers.get("Connection", "").lower()
            keep_alive = conn != "close" and (version != "HTTP/1.0" or conn == "keep-alive")
            try:
                payload = _payload_for(reader, headers)
            except HTTPException as exc:
                request = Request(app, method, target, version, headers,
                                  _Payload(reader, 0), remote=remote,
                                  writer=writer, keep_alive=False)
                await exc._send(request)
                return
            if headers.get("Expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await writer.drain()
            request = Request(app, method, target, version, headers, payload,
                              remote=remote, writer=writer, keep_alive=keep_alive)
            try:
                response = await app.handle(request)
            except HTTPException as exc:
                response = exc
            except asyncio.CancelledError:
                raise
            # ftc: ignore[silent-except] -- logged: one handler's crash must not take the listener down
            except Exception:
                logger.exception("unhandled error on %s %s", method, request.path)
                if request._upgraded:  # the socket speaks WebSocket now
                    return
                response = Response(status=500, text="500 Internal Server Error\n\n"
                                    "Server got itself in trouble")
            if isinstance(response, Response) and not response.prepared:
                await response._send(request)
            elif not response.prepared:
                raise RuntimeError(f"{method} {request.path}: handler returned an "
                                   "unprepared stream response")
            else:
                await response.write_eof()
            # the next request starts after this one's body, read or not
            if not request._keep_alive or not await payload.drain(_LINGER_S):
                return
    except (ConnectionError, asyncio.IncompleteReadError):
        return
    finally:
        with contextlib.suppress(Exception):
            writer.close()


class AppRunner:
    """Starts and cleans up an application (``aiohttp.web.AppRunner``)."""

    def __init__(self, app: Application):
        self.app = app
        self.sites: list["TCPSite"] = []

    async def setup(self) -> None:
        await self.app.startup()

    async def cleanup(self) -> None:
        for site in list(self.sites):
            await site.stop()
        await self.app.cleanup()


class TCPSite:
    """Listens for one runner's application (``aiohttp.web.TCPSite``);
    port 0 binds an ephemeral port, read back from :attr:`port`."""

    def __init__(self, runner: AppRunner, host: str = "127.0.0.1", port: int = 8080,
                 *, reuse_port: bool = False):
        self.runner = runner
        self.host = host
        self._port = port
        self.reuse_port = reuse_port
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[asyncio.Task] = set()

    @property
    def port(self) -> int:
        if self._server is not None and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self._port

    async def start(self) -> None:
        app = self.runner.app

        async def on_connect(reader, writer):
            task = asyncio.current_task()
            self._conns.add(task)
            try:
                await _serve_connection(app, reader, writer)
            finally:
                self._conns.discard(task)

        self._server = await asyncio.start_server(
            on_connect, self.host, self._port, limit=_MAX_HEAD_BYTES,
            reuse_port=self.reuse_port or None)
        self.runner.sites.append(self)

    async def stop(self) -> None:
        """Stop listening; close each open WebSocket with 1001 (going away)
        and each connection's writer, then wait for the listener: on Python
        3.12 ``wait_closed`` waits for every connection, so a writer left
        open would hang it."""
        if self._server is None:
            return
        self._server.close()
        sockets = list(self.runner.app._websockets)
        await asyncio.gather(*(ws.close(code=WSCloseCode.GOING_AWAY, timeout=_WS_SHUTDOWN_S)
                               for ws in sockets), return_exceptions=True)
        # their handlers see the close and return before the rest is cancelled
        handlers = [ws._task for ws in sockets if ws._task is not None]
        if handlers:
            await asyncio.wait(handlers, timeout=_WS_SHUTDOWN_S)
        for task in list(self._conns):
            task.cancel()
        for task in list(self._conns):
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await task
        with contextlib.suppress(Exception):
            await self._server.wait_closed()
        self._server = None
        if self in self.runner.sites:
            self.runner.sites.remove(self)


def run_app(app: Application, *, host: str = "127.0.0.1", port: int = 8080,
            reuse_port: bool = False) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then clean it up."""

    async def main() -> None:
        runner = AppRunner(app)
        await runner.setup()
        try:
            site = TCPSite(runner, host, port, reuse_port=reuse_port)
            await site.start()
            logger.info("serving on http://%s:%d", host, site.port)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                with contextlib.suppress(NotImplementedError, RuntimeError):
                    loop.add_signal_handler(sig, stop.set)
            await stop.wait()
        finally:
            await runner.cleanup()

    asyncio.run(main())
