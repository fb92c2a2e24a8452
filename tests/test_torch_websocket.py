"""The port's server-side WebSocket (``controller/web.py``) against
``aiohttp``'s client, and the port's client (``controller/httpclient.py``)
against ``aiohttp.web``'s server.

An echo handler answers each message with its bytes; frames of 0, 125,
126 and 70000 bytes (the 7-bit, 16-bit and 64-bit length forms) come back
equal, as does a fragmented client message sent on a raw socket.  Ping
and pong, the close handshake in both directions, the heartbeat closing a
peer that answers no ping (close code 1006), a 400 for a GET without the
upgrade, and the server's stop returning within 5 s while a WebSocket is
open (a 1001 close frame reaches the client).  The same exchanges through
the port's client against ``aiohttp.web`` give the same frames.  Tolerance:
exact, on bytes, text and close codes.  Every wait sits under a timeout.
"""

from __future__ import annotations

import asyncio
import base64
import os
import struct

import aiohttp
from aiohttp import web as aioweb

from conftest import run_async as run
from finetune_controller_tpu_torch.controller import httpclient, web

SIZES = (0, 125, 126, 70000)
WAIT = 10.0


async def _echo(request):
    ws = web.WebSocketResponse(heartbeat=request.app["heartbeat"])
    await ws.prepare(request)
    request.app["open"].append(ws)
    async for msg in ws:
        if msg.type == web.WSMsgType.TEXT:
            if msg.data == "close-me":
                await ws.close(code=4000, message=b"bye")
                break
            await ws.send_str(msg.data)
        elif msg.type == web.WSMsgType.BINARY:
            await ws.send_bytes(msg.data)
    request.app["closed"].append((ws.close_code, ws.closed))
    return ws


async def _port_server(heartbeat=None):
    app = web.Application()
    app["heartbeat"] = heartbeat
    app["open"], app["closed"] = [], []
    app.router.add_get("/ws", _echo)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return app, runner, f"http://127.0.0.1:{site.port}/ws"


async def _raw_handshake(url: str):
    """A raw socket that upgrades and then sends what the test writes."""
    host, port = url.split("//")[1].split("/")[0].split(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET /ws HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                  f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), WAIT)
    assert head.startswith(b"HTTP/1.1 101 ")
    assert web.ws_accept_key(key).encode() in head
    return reader, writer


def _client_frame(opcode: int, payload: bytes, fin: bool) -> bytes:
    """A masked client frame, encoded here independently of the port."""
    mask = os.urandom(4)
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode])
    if n < 126:
        head += bytes([0x80 | n])
    elif n < 65536:
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    return head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))


async def _read_server_frame(reader) -> tuple[int, bytes]:
    b0, b1 = await asyncio.wait_for(reader.readexactly(2), WAIT)
    assert not b1 & 0x80, "a server frame must not be masked"
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack(">H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", await reader.readexactly(8))[0]
    return b0 & 0x0F, await reader.readexactly(n)


async def _until(cond, timeout: float = WAIT) -> None:
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.02)


def test_accept_key_is_the_rfc_example():
    # RFC 6455 §1.3
    assert web.ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_frames_of_each_length_form_echo_through_aiohttp_client():
    async def go():
        app, runner, url = await _port_server()
        async with aiohttp.ClientSession() as session:
            ws = await session.ws_connect(url)
            for n in SIZES:
                text = "é" * (n // 2) + "x" * (n % 2)
                await ws.send_str(text)
                msg = await ws.receive(timeout=WAIT)
                assert (msg.type, msg.data) == (aiohttp.WSMsgType.TEXT, text)
                blob = os.urandom(n)
                await ws.send_bytes(blob)
                msg = await ws.receive(timeout=WAIT)
                assert (msg.type, msg.data) == (aiohttp.WSMsgType.BINARY, blob)
            await ws.close()
            assert ws.close_code == 1000
        await asyncio.wait_for(runner.cleanup(), WAIT)
        assert app["closed"] == [(1000, True)]

    run(go())


def test_fragmented_client_message_and_server_frame_lengths():
    async def go():
        app, runner, url = await _port_server()
        reader, writer = await _raw_handshake(url)
        parts = [b"frag", b"mented " * 20, b"x" * 70000]
        writer.write(_client_frame(0x1, parts[0], fin=False))
        writer.write(_client_frame(0x9, b"mid", fin=True))  # a ping between fragments
        writer.write(_client_frame(0x0, parts[1], fin=False))
        writer.write(_client_frame(0x0, parts[2], fin=True))
        await writer.drain()
        assert await _read_server_frame(reader) == (0xA, b"mid")
        assert await _read_server_frame(reader) == (0x1, b"".join(parts))
        for n in SIZES:
            writer.write(_client_frame(0x2, b"\x07" * n, fin=True))
            await writer.drain()
            assert await _read_server_frame(reader) == (0x2, b"\x07" * n)
        writer.write(_client_frame(0x8, struct.pack(">H", 1000), fin=True))
        await writer.drain()
        assert await _read_server_frame(reader) == (0x8, struct.pack(">H", 1000))
        assert await asyncio.wait_for(reader.read(), WAIT) == b""  # the server closes TCP
        writer.close()
        await asyncio.wait_for(runner.cleanup(), WAIT)
        assert app["closed"] == [(1000, True)]

    run(go())


def test_unmasked_client_frame_is_a_protocol_error():
    async def go():
        app, runner, url = await _port_server()
        reader, writer = await _raw_handshake(url)
        writer.write(b"\x81\x02hi")  # unmasked text frame
        await writer.drain()
        assert await _read_server_frame(reader) == (0x8, struct.pack(">H", 1002))
        writer.close()
        await asyncio.wait_for(runner.cleanup(), WAIT)
        assert app["closed"] == [(1002, True)]

    run(go())


def test_ping_pong_and_server_close():
    async def go():
        app, runner, url = await _port_server(heartbeat=0.2)
        async with aiohttp.ClientSession() as session:
            ws = await session.ws_connect(url, autoping=False)
            await ws.ping(b"abc")
            msg = await ws.receive(timeout=WAIT)
            assert (msg.type, msg.data) == (aiohttp.WSMsgType.PONG, b"abc")
            # silent for a heartbeat: the server pings
            msg = await ws.receive(timeout=WAIT)
            assert msg.type == aiohttp.WSMsgType.PING
            await ws.pong(msg.data)
            await ws.send_str("still here")
            assert (await ws.receive(timeout=WAIT)).data == "still here"
            await ws.send_str("close-me")
            msg = await ws.receive(timeout=WAIT)
            assert (msg.type, msg.data, msg.extra) == (aiohttp.WSMsgType.CLOSE, 4000, "bye")
            await ws.close()
        await _until(lambda: app["closed"])
        await asyncio.wait_for(runner.cleanup(), WAIT)
        assert app["closed"] == [(4000, True)]

    run(go())


def test_heartbeat_closes_a_silent_peer():
    async def go():
        app, runner, url = await _port_server(heartbeat=0.3)
        reader, writer = await _raw_handshake(url)
        # never answer: the server pings after 0.3 s, gives up 0.15 s later
        opcode, _ = await _read_server_frame(reader)
        assert opcode == 0x9
        await _until(lambda: app["closed"])
        assert app["closed"] == [(1006, True)]
        writer.close()
        await asyncio.wait_for(runner.cleanup(), WAIT)

    run(go())


def test_plain_get_is_400_and_stop_with_an_open_websocket_returns():
    async def go():
        app, runner, url = await _port_server()
        async with aiohttp.ClientSession() as session:
            async with session.get(url) as resp:
                assert resp.status == 400
                assert "No WebSocket UPGRADE hdr" in await resp.text()
            ws = await session.ws_connect(url)
            await ws.send_str("hi")
            assert (await ws.receive(timeout=WAIT)).data == "hi"
            # the client reads (and answers the close) while the server stops
            recv = asyncio.ensure_future(ws.receive(timeout=WAIT))
            t0 = asyncio.get_running_loop().time()
            await asyncio.wait_for(runner.cleanup(), 5.0)
            assert asyncio.get_running_loop().time() - t0 < 5.0
            msg = await asyncio.wait_for(recv, WAIT)
            assert (msg.type, msg.data) == (aiohttp.WSMsgType.CLOSE, 1001)
            await ws.close()
        assert app["closed"] == [(1001, True)]

    run(go())


def test_port_client_against_aiohttp_server_gives_the_same_frames():
    async def aio_echo(request):
        ws = aioweb.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == aiohttp.WSMsgType.TEXT:
                await ws.send_str(msg.data)
            elif msg.type == aiohttp.WSMsgType.BINARY:
                await ws.send_bytes(msg.data)
        return ws

    async def exchange(url: str) -> list:
        out = []
        session = httpclient.ClientSession()
        ws = await session.ws_connect(url)
        for n in SIZES:
            await ws.send_str("y" * n)
            msg = await ws.receive(timeout=WAIT)
            out.append((int(msg.type), msg.data))
            await ws.send_bytes(bytes(range(256)) * (n // 256) + b"\x01" * (n % 256))
            msg = await ws.receive(timeout=WAIT)
            out.append((int(msg.type), msg.data))
        await ws.ping(b"p")
        await ws.close()
        out.append(ws.close_code)
        await session.close()
        return out

    async def go():
        app = aioweb.Application()
        app.router.add_get("/ws", aio_echo)
        runner = aioweb.AppRunner(app)
        await runner.setup()
        site = aioweb.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        theirs = await asyncio.wait_for(exchange(f"http://127.0.0.1:{port}/ws"), 30)
        await runner.cleanup()
        _, port_runner, url = await _port_server()
        ours = await asyncio.wait_for(exchange(url), 30)
        await asyncio.wait_for(port_runner.cleanup(), WAIT)
        assert ours == theirs
        assert theirs[-1] == 1000 and [len(d) for _, d in theirs[:-1]] == [
            n for n in SIZES for _ in (0, 1)]

    run(go())
