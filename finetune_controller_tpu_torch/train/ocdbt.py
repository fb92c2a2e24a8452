"""Read the JAX package's orbax checkpoints: an OCDBT key-value store of
zarr v2 arrays, without tensorstore, orbax or a zstd package.

A one-process save of ``finetune_controller_tpu/train/checkpoint.py``
(``ocp.StandardCheckpointer``) leaves in ``step_N/``:

* ``_METADATA`` — JSON: ``tree_metadata`` maps each leaf's key path (dict
  keys and sequence indices) to its value type; ``use_ocdbt`` true,
  ``use_zarr3`` false;
* ``manifest.ocdbt`` and ``d/…`` — the step's OCDBT database, whose B-tree
  refers to the value files of the per-process database under
  ``ocdbt.process_0/`` (its own ``manifest.ocdbt`` and ``d/…``).

This module follows tensorstore's published OCDBT format.  Each manifest
and B-tree node is a file (or a region of a ``d/`` file) framed as a
big-endian magic (``0c db 3a 2a`` manifest, ``0c db 20 de`` node), its
length (u64 little-endian), a varint format version (0), a varint
compression (0 none, 1 zstd), the body and a CRC-32C (little-endian) of
everything before it; :func:`read_framed` checks each.  A manifest holds
the database config, a data file table and the version tree's newest
versions, each naming its B-tree root (file, offset, length, height); a
node holds its data file table (paths relative to the file holding the
node), its entries' keys as prefix lengths, suffix lengths and suffixes
(an interior entry also the length of its subtree's common key prefix,
which the child's keys leave out) and, in a leaf, each value inline or as
a reference (file, offset, length) into a ``d/`` file.  Values are zarr v2
``.zarray`` documents and chunks; a chunk is a zstd frame, decoded by the
native decoder ``csrc/zstd_decode.cc`` (built with the host compiler at
first use, :func:`zstd_decompress`): there is no fallback to the plain
Python decoder of ``utils/zstd.py``, which the tests hold it against.

:func:`read_orbax_tree` turns a step directory into the nested dict the
``tree_metadata`` describes: dict keys and sequence indices both as string
keys (as flax's ``to_state_dict`` gives a tuple), numpy arrays for every
dtype numpy holds and ``torch.bfloat16`` tensors for ``bfloat16`` (numpy has
none), ``None`` for a leaf orbax skipped (an empty optimizer state).
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
from pathlib import Path
from typing import Any

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A checkpoint file this reader refuses, named with the offset."""


# ---------------------------------------------------------------------------
# the native zstd decoder
# ---------------------------------------------------------------------------


@functools.cache
def _native() -> ctypes.CDLL:
    from ..ops.kernels.build import load_host

    lib = load_host("zstd_decode")
    lib.ftc_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.c_char_p, ctypes.c_size_t]
    lib.ftc_zstd_decompress.restype = ctypes.c_int
    lib.ftc_zstd_content_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ftc_zstd_content_size.restype = ctypes.c_longlong
    return lib


def zstd_decompress(data: bytes, size: int | None = None) -> bytes:
    """Every zstd frame of ``data`` decoded by ``csrc/zstd_decode.cc``.
    ``size`` is the expected output length where the caller knows it; else
    the frames' declared content size, else a buffer that grows.  Raises
    :class:`OcdbtError` with the decoder's message (byte offset included)
    for a corrupt frame, and ``RuntimeError`` naming the compiler's output
    when the library cannot be built or loaded."""
    lib = _native()
    data = bytes(data)
    cap = size if size is not None else lib.ftc_zstd_content_size(data, len(data))
    grow = cap < 0
    cap = max(cap, 4 * len(data) + 1024) if grow else cap
    err = ctypes.create_string_buffer(512)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        written = ctypes.c_size_t()
        rc = lib.ftc_zstd_decompress(data, len(data), out.ctypes.data, cap,
                                     ctypes.byref(written), err, len(err))
        if rc == 2 and grow:
            cap *= 4
            continue
        if rc:
            raise OcdbtError(err.value.decode())
        if size is not None and written.value != size:
            raise OcdbtError(f"zstd data decodes to {written.value} bytes, expected {size}")
        return out[:written.value].tobytes()


# ---------------------------------------------------------------------------
# framing, varints, CRC-32C
# ---------------------------------------------------------------------------


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT files carry it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Fields of a decoded body; errors name the file and offset."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, reason: str):
        raise OcdbtError(f"{self.where}: {reason} at body offset {self.pos}")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("varint past the end")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"{n} bytes past the end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def read_framed(data: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or B-tree node: magic, length and CRC-32C
    checked, decompressed if the frame says zstd."""
    if len(data) < 4 + 8 + 2 + 4:
        raise OcdbtError(f"{where}: {len(data)} bytes is too short for an OCDBT file")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OcdbtError(f"{where}: magic {got:#010x} at offset 0, expected {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{where}: length field {length} at offset 4, the file has "
                         f"{len(data)} bytes")
    want = int.from_bytes(data[-4:], "little")
    if crc32c(data[:-4]) != want:
        raise OcdbtError(f"{where}: CRC-32C mismatch (stored {want:#010x} at offset "
                         f"{len(data) - 4})")
    r = _Reader(data[:-4], where)
    r.pos = 12
    version = r.varint()
    if version != 0:
        r.fail(f"format version {version}")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd_decompress(body)
        except OcdbtError as e:
            raise OcdbtError(f"{where}: body at offset {r.pos}: {e}") from None
    raise OcdbtError(f"{where}: unknown compression {compression} at offset 13")


# ---------------------------------------------------------------------------
# manifest and B-tree
# ---------------------------------------------------------------------------


def _data_file_table(r: _Reader, transitive: str) -> list[tuple[str, str]]:
    """(base path, full path) of each data file, both relative to the
    database's directory; ``transitive`` is the base path of the file the
    table was read from."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], ""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail(f"data file {i}: prefix {prefix[i]} longer than the previous path")
        path = prev[:prefix[i]] + r.take(suffix[i]).decode()
        if base[i] > len(path):
            r.fail(f"data file {i}: base path longer than the path")
        files.append((transitive + path[:base[i]], transitive + path))
        prev = path
    return files


def _file_ref(files, i: int, r: _Reader) -> tuple[str, str]:
    if i >= len(files):
        r.fail(f"data file id {i} of {len(files)}")
    return files[i]


def read_manifest(db: Path) -> dict:
    """The newest version of the database in ``db``: ``{"generation",
    "root": (base, path, offset, length) or None, "height", "num_keys"}``."""
    path = db / "manifest.ocdbt"
    where = str(path)
    body = read_framed(path.read_bytes(), MANIFEST_MAGIC, where)
    r = _Reader(body, where)
    r.take(16)  # uuid
    kind = r.varint()
    if kind != 0:
        r.fail(f"manifest kind {kind}: only single-file manifests are read")
    r.varint()  # max inline value bytes
    r.varint()  # max decoded node bytes
    r.take(1)   # version tree arity log2
    if r.varint() == 1:
        r.take(4)  # zstd level
    files = _data_file_table(r, "")
    n = r.varint()
    if n == 0:
        r.fail("no version")
    gens = r.varints(n)
    heights = r.take(n)
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    num_keys = r.varints(n)
    r.varints(n)  # tree bytes
    r.varints(n)  # indirect value bytes
    r.take(8 * n)  # commit times
    r.varint()  # version tree interior nodes (older generations only)
    last = max(range(n), key=lambda i: gens[i])
    root = None
    if lengths[last]:
        root = (*_file_ref(files, ids[last], r), offsets[last], lengths[last])
    return {"generation": gens[last], "root": root, "height": heights[last],
            "num_keys": num_keys[last]}


def _read_region(db: Path, path: str, offset: int, length: int) -> bytes:
    with open(db / path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise OcdbtError(f"{db / path}: region ({offset}, {length}) past the end of the file")
    return data


def _walk(db: Path, ref, height: int, prefix: bytes, out: dict) -> None:
    """Every key under the node ``ref`` into ``out``: key -> bytes (inline)
    or (path, offset, length)."""
    base, path, offset, length = ref
    where = f"{db / path} node at ({offset}, {length})"
    body = read_framed(_read_region(db, path, offset, length), NODE_MAGIC, where)
    r = _Reader(body, where)
    got = r.take(1)[0]
    if got != height:
        r.fail(f"height {got}, its parent says {height}")
    files = _data_file_table(r, base)
    n = r.varint()
    key_prefix = [0] + r.varints(n - 1) if n else []
    key_suffix = r.varints(n)
    subtree_prefix = r.varints(n) if height else []
    keys, prev = [], b""
    for i in range(n):
        if key_prefix[i] > len(prev):
            r.fail(f"entry {i}: key prefix {key_prefix[i]} longer than the previous key")
        prev = prev[:key_prefix[i]] + r.take(key_suffix[i])
        keys.append(prev)
    if height:
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n)  # keys
        r.varints(n)  # tree bytes
        r.varints(n)  # indirect value bytes
        r.end()
        for i in range(n):
            child = (*_file_ref(files, ids[i], r), offsets[i], lengths[i])
            _walk(db, child, height - 1, prefix + keys[i][:subtree_prefix[i]], out)
        return
    lengths = r.varints(n)
    kinds = r.take(n)
    indirect = [i for i in range(n) if kinds[i] == 1]
    if any(k > 1 for k in kinds):
        r.fail("unknown value kind")
    ids = r.varints(len(indirect))
    offsets = r.varints(len(indirect))
    refs = dict(zip(indirect, zip(ids, offsets)))
    for i in range(n):
        key = prefix + keys[i]
        if i in refs:
            fid, off = refs[i]
            out[key] = (_file_ref(files, fid, r)[1], off, lengths[i])
        else:
            out[key] = r.take(lengths[i])
    r.end()


class KvStore:
    """The newest version of one OCDBT database, read-only."""

    def __init__(self, db: str | Path):
        self.db = Path(db)
        self.manifest = read_manifest(self.db)
        self.entries: dict[bytes, Any] = {}
        if self.manifest["root"] is not None:
            _walk(self.db, self.manifest["root"], self.manifest["height"], b"", self.entries)
        if len(self.entries) != self.manifest["num_keys"]:
            raise OcdbtError(f"{self.db}: {len(self.entries)} keys in the tree, its manifest "
                             f"says {self.manifest['num_keys']}")

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self.entries)

    def get(self, key: str) -> bytes | None:
        value = self.entries.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return _read_region(self.db, *value)


def open_step(step_dir: str | Path) -> KvStore:
    """The step's database: the step-root one, checked against the
    per-process databases whose files it refers to (their keys together
    are its keys); or, without a step-root manifest, the one process's."""
    step_dir = Path(step_dir)
    procs = sorted(p for p in step_dir.glob("ocdbt.process_*") if p.is_dir())
    if not (step_dir / "manifest.ocdbt").exists():
        if len(procs) != 1:
            raise OcdbtError(f"{step_dir}: no manifest.ocdbt and {len(procs)} per-process "
                             "databases")
        return KvStore(procs[0])
    root = KvStore(step_dir)
    merged: set[str] = set()
    for proc in procs:
        merged |= set(KvStore(proc).keys())
    if procs and merged != set(root.keys()):
        missing = sorted(set(root.keys()) ^ merged)[:4]
        raise OcdbtError(f"{step_dir}: the step-root database and the per-process ones hold "
                         f"different keys ({missing} ...)")
    return root


# ---------------------------------------------------------------------------
# zarr v2 arrays and the orbax tree
# ---------------------------------------------------------------------------

#: zarr dtype -> numpy storage (bf16 as its bits)
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<f8": np.float64, "<i4": np.int32,
           "<u4": np.uint32, "<i8": np.int64, "bfloat16": np.uint16}


def read_array(store: KvStore, name: str):
    """The zarr v2 array ``name``: C order, zstd-compressed (or raw)
    chunks, a missing chunk filled with ``fill_value``.  A numpy array, or
    a ``torch.bfloat16`` tensor for dtype ``bfloat16``."""
    meta_raw = store.get(f"{name}/.zarray")
    if meta_raw is None:
        raise OcdbtError(f"{store.db}: no {name}/.zarray")
    meta = json.loads(meta_raw)
    if meta.get("zarr_format") != 2:
        raise OcdbtError(f"{name}: zarr format {meta.get('zarr_format')} (only v2 is read)")
    dtype_name = meta["dtype"]
    if dtype_name not in _DTYPES:
        raise OcdbtError(f"{name}: dtype {dtype_name!r} is not read")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise OcdbtError(f"{name}: order {meta.get('order')} / filters {meta.get('filters')} "
                         "(only C order without filters is read)")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OcdbtError(f"{name}: compressor {compressor.get('id')!r} (only zstd is read)")
    dtype = np.dtype(_DTYPES[dtype_name])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value") or 0
    if dtype_name == "bfloat16" and fill:
        import torch

        fill = int(torch.tensor(fill, dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    out = np.full(shape, fill, dtype=dtype)
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid) if shape else [()]:
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        raw = store.get(key)
        if raw is None:
            continue
        size = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
        data = zstd_decompress(raw, size) if compressor is not None else raw
        if len(data) != size:
            raise OcdbtError(f"{key}: {len(data)} bytes, a chunk of {chunks} holds {size}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, x.stop - x.start) for x in sl)]
    if dtype_name == "bfloat16":
        import torch

        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def read_orbax_tree(step_dir: str | Path) -> dict:
    """The nested dict of a step directory's ``_METADATA`` tree, each leaf
    read from the step's OCDBT database (sequence indices as string
    keys; a leaf orbax skipped is None)."""
    step_dir = Path(step_dir)
    meta = json.loads((step_dir / "_METADATA").read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise OcdbtError(f"{step_dir}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')}: only OCDBT with zarr v2 is read")
    store = open_step(step_dir)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value_meta = entry["value_metadata"]
        if value_meta.get("skip_deserialize") or value_meta.get("value_type") == "None":
            value = None
        else:
            value = read_array(store, ".".join(keys))
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return tree
