"""flax's msgpack format, written and read with the standard library.

``flax.serialization.msgpack_serialize`` encodes a tree of dicts, lists,
strings, numbers and arrays as MessagePack, each array as extension type 1
holding the MessagePack of ``(shape, dtype name, row-major bytes)``.  The
reference writes a reward job's head (``reward_head.msgpack``) and its
checkpoints' ``state.msgpack`` that way; the port has neither ``flax`` nor
``msgpack`` on the card, so it carries its own coder:

* :func:`serialize` gives the bytes ``msgpack_serialize`` gives for a tree of
  dicts (keys sorted, as flax's tree copy sorts them), lists and tuples,
  ``str``, ``bytes``, ``bool``, ``int``, ``float``, ``None``, numpy arrays
  and torch tensors (as arrays); subclasses of these (a ``str`` enum, a
  ``defaultdict``) are written as their base type, which also makes it the
  serve transport's MessagePack codec (``transport/wire.py``);
* :func:`restore` reads such bytes back (maps, arrays, strings, binary,
  numbers, extension type 1 and the numpy-scalar type 3) into dicts, lists
  and numpy arrays; a ``bfloat16`` array, which numpy cannot hold, comes
  back as a torch tensor.

flax splits arrays above 1 GiB into chunks; this coder refuses them.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

#: flax's extension type codes
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
#: flax chunks array leaves above this many bytes; this coder does not
MAX_ARRAY_BYTES = 2**30


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out += struct.pack("B", n)
    elif -0x20 <= n < 0:
        out += struct.pack("b", n)
    elif 0x80 <= n <= 0xFF:
        out += struct.pack(">BB", 0xCC, n)
    elif -0x80 <= n < 0:
        out += struct.pack(">Bb", 0xD0, n)
    elif 0xFF < n <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, n)
    elif -0x8000 <= n < -0x80:
        out += struct.pack(">Bh", 0xD1, n)
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, n)
    elif -0x80000000 <= n < -0x8000:
        out += struct.pack(">Bi", 0xD2, n)
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += struct.pack(">Bq", 0xD3, n)
    else:
        raise OverflowError(f"integer {n} does not fit MessagePack")


def _pack_len(n: int, out: bytearray, fix: tuple[int, int] | None, codes: tuple[int, ...]
              ) -> None:
    """A length header: ``fix`` = (base, limit) of the fix form, ``codes``
    the 8-, 16- and 32-bit forms (None where the type has none)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack("b", code)
    out += data


def _array_bytes(arr: np.ndarray, dtype_name: str) -> bytes:
    """flax's ``_ndarray_to_bytes``: the MessagePack of (shape, dtype name,
    C-order bytes)."""
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it; "
                         "this coder does not")
    inner = bytearray()
    _pack((tuple(int(d) for d in arr.shape), dtype_name, arr.tobytes("C")), inner)
    return bytes(inner)


def _as_array(x: Any) -> tuple[np.ndarray, str] | None:
    """(C-order numpy array, flax dtype name) of an array leaf, else None."""
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        return x, x.dtype.name
    try:
        import torch
    except ImportError:  # pragma: no cover - the port always has torch
        return None
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), t.numpy().dtype.name
    return None


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, np.generic):
        # before the Python number types: np.float64 subclasses float
        arr = np.asarray(x)
        _pack_ext(EXT_NPSCALAR, _array_bytes(arr, arr.dtype.name), out)
    elif isinstance(x, int):
        _pack_int(int(x), out)
    elif isinstance(x, float):
        out += struct.pack(">Bd", 0xCB, float(x))
    elif isinstance(x, str):
        data = str.encode(x, "utf-8")
        _pack_len(len(data), out, (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _pack_len(len(data), out, None, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), out, (0x90, 16), (None, 0xDC, 0xDD))
        for item in x:
            _pack(item, out)
    elif isinstance(x, dict):
        _pack_len(len(x), out, (0x80, 16), (None, 0xDE, 0xDF))
        for key in sorted(x):
            _pack(key, out)
            _pack(x[key], out)
    else:
        array = _as_array(x)
        if array is None:
            raise TypeError(f"cannot serialize {type(x).__name__}")
        _pack_ext(EXT_NDARRAY, _array_bytes(*array), out)


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False) -> Any:
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self._ext(self.unpack(ext[b]))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strings = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strings:
            return self._str(self.unpack(strings[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.value(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def _str(self, n: int, raw: bool):
        data = self.take(n)
        return data if raw else data.decode("utf-8")

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def _ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported MessagePack extension type {code}")
        inner = _Reader(data)
        shape, dtype_name, buffer = inner.value(raw=True)
        array = _array_from(tuple(shape), dtype_name.decode(), buffer)
        if code == EXT_NPSCALAR and isinstance(array, np.ndarray):
            return array[()]
        return array


def _array_from(shape: tuple[int, ...], dtype_name: str, buffer: bytes):
    if dtype_name == "bfloat16":
        import torch

        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def restore(data: bytes) -> Any:
    """The tree of ``data`` (``flax.serialization.msgpack_restore``'s
    result for unchunked arrays)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the tree")
    return tree
