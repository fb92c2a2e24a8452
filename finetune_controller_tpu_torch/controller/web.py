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
* :class:`AppRunner` + :class:`TCPSite` and :func:`run_app` to serve an
  application on ``asyncio.start_server``.

Only what the handlers need is here: no WebSocket upgrade, no HTTP/2, no
compression.  A body stays on the socket until the handler reads it:
``read()``/``json()`` take it whole, up to ``client_max_size``, while
``multipart()`` streams it field by field with no size limit, so a dataset
upload is never held in memory whole.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import re
import signal
from collections.abc import MutableMapping
from http import HTTPStatus
from http.cookies import SimpleCookie
from typing import Any, Awaitable, Callable, Iterator
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
            body = bytearray()
            while chunk := await self._payload.readany():
                body += chunk
                if len(body) > limit:
                    raise HTTPRequestEntityTooLarge(
                        text=f"Maximum request body size {limit} exceeded, "
                             f"actual body size {len(body)}")
            self._read_bytes = bytes(body)
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
    """A route's path: ``/a/{name}/b`` matches one segment per ``{name}``."""

    def __init__(self, path: str):
        self.path = path
        self.dynamic = "{" in path
        pattern = re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)", re.escape(path))
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
            if not keep_alive or not await payload.drain(_LINGER_S):
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
        if self._server is None:
            return
        self._server.close()
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
