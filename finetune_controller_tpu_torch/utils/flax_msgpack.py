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
  back as a torch tensor;
* :func:`dump` writes :func:`serialize`'s bytes to a file as it goes, each
  array's memory straight from the array (a model's base is gigabytes).

An array above 1 GiB that is a map's value (or the whole tree) is written
as flax writes it, as a map of flat chunks of at most 1 GiB
(``{"__msgpack_chunked_array__": true, "shape": {...}, "chunks": {...}}``,
in that order), and :func:`restore` joins such a map back into one array;
an array above 1 GiB inside a list is refused, as flax cannot write it
either.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

#: flax's extension type codes
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
#: flax chunks array leaves above this many bytes (``MAX_CHUNK_SIZE``)
MAX_ARRAY_BYTES = 2**30
#: the key that marks a chunked array's map
CHUNKED = "__msgpack_chunked_array__"


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


def _pack_ext_header(code: int, n: int, out) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC7, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack("b", code)


def _pack_array(code: int, arr: np.ndarray, dtype_name: str, out) -> None:
    """flax's ``_ndarray_to_bytes`` as an extension of type ``code``: the
    MessagePack of (shape, dtype name, C-order bytes), the bytes appended
    from the array's own memory."""
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes inside a list: flax cannot "
                         "chunk it there, and neither does this coder")
    if not arr.flags["C_CONTIGUOUS"]:
        arr = arr.copy(order="C")
    prefix = bytearray([0x93])  # the (shape, dtype, bytes) triple
    _pack(tuple(int(d) for d in arr.shape), prefix)
    _pack(dtype_name, prefix)
    _pack_len(arr.nbytes, prefix, None, (0xC4, 0xC5, 0xC6))
    _pack_ext_header(code, len(prefix) + arr.nbytes, out)
    out += prefix
    out += memoryview(arr.reshape(-1).view(np.uint8))


def _pack_chunked(arr: np.ndarray, dtype_name: str, out) -> None:
    """flax's ``_chunk``: the marker, the shape and the flat chunks, in
    flax's insertion order (not sorted)."""
    size = max(1, MAX_ARRAY_BYTES // arr.dtype.itemsize)
    flat = np.ascontiguousarray(arr).reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    out.append(0x83)
    _pack(CHUNKED, out)
    _pack(True, out)
    _pack("shape", out)
    _pack_len(arr.ndim, out, (0x80, 16), (None, 0xDE, 0xDF))
    for i, d in enumerate(arr.shape):
        _pack(str(i), out)
        _pack(int(d), out)
    _pack("chunks", out)
    _pack_len(len(chunks), out, (0x80, 16), (None, 0xDE, 0xDF))
    for i, chunk in enumerate(chunks):
        _pack(str(i), out)
        _pack_array(EXT_NDARRAY, chunk, dtype_name, out)


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


def _pack_value(x: Any, out) -> None:
    """A map's value (or the whole tree): an array above
    ``MAX_ARRAY_BYTES`` goes in chunks, as flax writes it."""
    array = _as_array(x)
    if array is None:
        _pack(x, out)
    elif array[0].nbytes > MAX_ARRAY_BYTES:
        _pack_chunked(*array, out)
    else:
        _pack_array(EXT_NDARRAY, *array, out)


def _pack(x: Any, out) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, np.generic):
        # before the Python number types: np.float64 subclasses float
        arr = np.asarray(x)
        _pack_array(EXT_NPSCALAR, arr, arr.dtype.name, out)
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
            _pack_value(x[key], out)
    else:
        array = _as_array(x)
        if array is None:
            raise TypeError(f"cannot serialize {type(x).__name__}")
        _pack_array(EXT_NDARRAY, *array, out)


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    out = bytearray()
    _pack_value(tree, out)
    return bytes(out)


class _FileSink:
    """``bytearray``'s ``+=`` and ``append`` onto a binary file, with small
    pieces gathered before each write."""

    def __init__(self, f, flush_at: int = 1 << 20):
        self.f, self.buf, self.flush_at = f, bytearray(), flush_at

    def append(self, byte: int) -> None:
        self.buf.append(byte)

    def __iadd__(self, data) -> "_FileSink":
        if len(data) >= self.flush_at:
            self.flush()
            self.f.write(data)
        else:
            self.buf += data
            if len(self.buf) >= self.flush_at:
                self.flush()
        return self

    def flush(self) -> None:
        if self.buf:
            self.f.write(self.buf)
            self.buf = bytearray()


def dump(tree: Any, f) -> None:
    """Write :func:`serialize`'s bytes of ``tree`` to the binary file ``f``
    without holding them in memory: each array's bytes go to the file from
    the array itself."""
    sink = _FileSink(f)
    _pack_value(tree, sink)
    sink.flush()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def view(self, n: int) -> memoryview:
        """The next ``n`` bytes, not copied."""
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def take(self, n: int) -> bytes:
        return self.view(n).tobytes()

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
        inner = _Reader(self.view(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported MessagePack extension type {code}")
        # the (shape, dtype name, bytes) triple; the bytes are not copied
        if inner.unpack("B") != 0x93:
            raise ValueError("malformed array extension")
        shape, dtype_name = inner.value(), inner.value()
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(inner.unpack("B"))
        if sized is None:
            raise ValueError("malformed array extension")
        buffer = inner.view(inner.unpack(sized))
        array = _array_from(tuple(shape), dtype_name, buffer)
        if code == EXT_NPSCALAR and isinstance(array, np.ndarray):
            return array[()]
        return array


def _array_from(shape: tuple[int, ...], dtype_name: str, buffer):
    """A read-only numpy view of ``buffer`` (a slice of the bytes being
    read), or a torch tensor of its own for ``bfloat16``."""
    if dtype_name == "bfloat16":
        import torch

        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(doc: dict) -> Any:
    """flax's ``_unchunk``: the chunks joined and shaped."""
    shape = tuple(int(doc["shape"][str(i)]) for i in range(len(doc["shape"])))
    chunks = [doc["chunks"][str(i)] for i in range(len(doc["chunks"]))]
    if chunks and not isinstance(chunks[0], np.ndarray):  # bf16 torch tensors
        import torch

        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps that are the
    tree or a map's value become arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        return _unchunk(tree)
    for key, value in tree.items():
        tree[key] = _unchunk_leaves(value)
    return tree


def restore(data: bytes) -> Any:
    """The tree of ``data`` (``flax.serialization.msgpack_restore``'s
    result: chunked arrays joined)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the tree")
    return _unchunk_leaves(tree)
