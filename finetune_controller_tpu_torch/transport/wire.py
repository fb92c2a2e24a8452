"""Length-prefixed msgpack/JSON framing for the serve worker protocol.

One frame per message::

    u32 big-endian payload length | payload bytes

The payload is one document: MessagePack by default, written and read by
the port's stdlib coder (``utils/flax_msgpack.py``; the port has no
``msgpack`` package), so adapter blobs ride as native ``bytes``; or JSON
with base64-wrapped bytes when ``FTC_TRANSPORT_CODEC=json`` pins it.  The
reference speaks the same two codecs, so a frame of either package decodes
equal in the other (map keys come out sorted here; MessagePack maps are
unordered).

Messages are small dicts of plain values (str, int, float, bool, None,
bytes, lists and str-keyed dicts)::

    request:  {"op": str, "id": int, "payload": {...}}
    response: {"id": int, "ok": bool, "payload": {...}}            # success
              {"id": int, "ok": false,
               "error": {"type": str, "message": str, ...extras}}  # failure

``MAX_FRAME`` bounds one message (an adapter is megabytes; a gigabyte frame
is a bug, not a payload): an oversized length prefix tears the connection
down instead of allocating it.  Byte counters feed
``ftc_serve_transport_bytes_total`` (``transport.METRICS``).
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import struct
from typing import Any

from ..utils import flax_msgpack
from . import incr

#: hard per-frame ceiling: large enough for one full-width adapter, far
#: below a model's weights (those never ride this wire — workers rebuild
#: their model from disk themselves)
MAX_FRAME = 256 * (1 << 20)

_B64_KEY = "__ftc_b64__"


def codec_name() -> str:
    """``"json"`` when ``FTC_TRANSPORT_CODEC=json`` pins it, else
    ``"msgpack"`` (read at each call, so a test can switch it)."""
    forced = os.environ.get("FTC_TRANSPORT_CODEC", "").strip().lower() == "json"
    return "json" if forced else "msgpack"


def _json_default(obj: Any) -> Any:
    if isinstance(obj, (bytes, bytearray)):
        return {_B64_KEY: base64.b64encode(bytes(obj)).decode("ascii")}
    raise TypeError(f"unserializable wire object: {type(obj)!r}")


def _json_hook(obj: dict) -> Any:
    if len(obj) == 1 and _B64_KEY in obj:
        return base64.b64decode(obj[_B64_KEY])
    return obj


def dumps(obj: Any) -> bytes:
    if codec_name() == "msgpack":
        return flax_msgpack.serialize(obj)
    return json.dumps(obj, default=_json_default).encode("utf-8")


def loads(data: bytes) -> Any:
    if codec_name() == "msgpack":
        return flax_msgpack.restore(data)
    return json.loads(data.decode("utf-8"), object_hook=_json_hook)


def tree_to_blob(tree: Any) -> bytes:
    """flax-msgpack blob of a tree of tensors or arrays (host copies are
    taken leaf by leaf) — the adapter-delta wire format."""
    return flax_msgpack.serialize(tree)


def tree_from_blob(blob: bytes) -> Any:
    """Inverse of :func:`tree_to_blob`: a tree of numpy arrays (bf16 leaves
    as torch tensors)."""
    return flax_msgpack.restore(bytes(blob))


class FrameError(RuntimeError):
    """A torn or oversized frame — the connection is unusable afterwards."""


async def write_msg(writer: asyncio.StreamWriter, obj: Any) -> None:
    data = dumps(obj)
    if len(data) > MAX_FRAME:
        raise FrameError(f"frame of {len(data)} bytes exceeds MAX_FRAME")
    writer.write(len(data).to_bytes(4, "big") + data)
    incr("bytes_sent_total", len(data) + 4)
    await writer.drain()


async def read_msg(reader: asyncio.StreamReader) -> Any:
    """Read one frame; raises :class:`asyncio.IncompleteReadError` (EOF) or
    :class:`FrameError` (oversized or undecodable)."""
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "big")
    if length > MAX_FRAME:
        raise FrameError(f"frame length {length} exceeds MAX_FRAME")
    data = await reader.readexactly(length)
    incr("bytes_received_total", length + 4)
    try:
        return loads(data)
    except (ValueError, UnicodeDecodeError, struct.error) as e:
        raise FrameError(f"undecodable frame of {length} bytes: {e}") from e

