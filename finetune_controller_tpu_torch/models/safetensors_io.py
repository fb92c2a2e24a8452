"""Read and write the safetensors format with the standard library and torch.

The card machine has no ``safetensors`` package, so the port reads and
writes the format itself.  A file is

* an 8-byte little-endian unsigned header length ``N``;
* ``N`` bytes of JSON: for each tensor ``{"dtype", "shape",
  "data_offsets": [begin, end]}`` (offsets relative to the end of the
  header), and an optional ``"__metadata__"`` map of strings.  The header
  is padded with spaces to a multiple of 8 bytes, as the package pads it;
* the tensors' raw little-endian bytes.

:class:`SafetensorsFile` reads a file over a copy-on-write memory map:
:meth:`~SafetensorsFile.get_tensor` returns a CPU tensor viewing the mapped
bytes (``torch.frombuffer``; numpy has no bfloat16, so nothing goes
through numpy), which a copy to the card reads straight from the page
cache.  :func:`iter_dir_tensors` walks a checkpoint directory, sharded ones
through ``model.safetensors.index.json``.

:class:`StreamWriter` writes a file whose tensors are produced one at a
time: the header is computed from the declared names, dtypes and shapes,
then each tensor is written as it arrives, so a checkpoint is never held in
host memory at once.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from pathlib import Path
from typing import Iterable, Iterator, Mapping

import torch

#: safetensors dtype codes <-> torch dtypes
DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
CODES: dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
INDEX_FILENAME = "model.safetensors.index.json"


def _nbytes(dtype: torch.dtype, shape) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class SafetensorsFile:
    """One safetensors file, memory-mapped copy-on-write (the tensors it
    hands out may be written to without touching the file)."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{self.path}: {size} bytes is too short for a header")
            (n,) = struct.unpack("<Q", f.read(8))
            if 8 + n > size:
                raise ValueError(f"{self.path}: header of {n} bytes runs past the file")
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
        self._data_start = 8 + n
        self._metadata = header.pop("__metadata__", None)
        self._entries: dict[str, dict] = header
        for name, entry in header.items():
            begin, end = entry["data_offsets"]
            if entry["dtype"] not in DTYPES:
                raise ValueError(f"{self.path}: tensor {name!r} has unknown dtype {entry['dtype']}")
            if end - begin != _nbytes(DTYPES[entry["dtype"]], entry["shape"]) or \
                    self._data_start + end > size:
                raise ValueError(f"{self.path}: tensor {name!r} has bad data_offsets")

    def keys(self) -> list[str]:
        """Tensor names in the order their bytes lie in the file."""
        return sorted(self._entries, key=lambda k: self._entries[k]["data_offsets"][0])

    def metadata(self) -> dict[str, str] | None:
        return self._metadata

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._entries[name]["dtype"]]

    def shape(self, name: str) -> list[int]:
        return list(self._entries[name]["shape"])

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor as a CPU view of the mapped bytes (no copy)."""
        entry = self._entries[name]
        dtype, shape = DTYPES[entry["dtype"]], entry["shape"]
        begin, end = entry["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._map, dtype=dtype, count=math.prod(shape),
                                offset=self._data_start + begin)
        return flat.reshape(shape)

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        # tensors handed out keep the map alive; it closes with the last one
        self._map = None


def checkpoint_files(ckpt_dir: str | os.PathLike) -> list[Path]:
    """The safetensors files of a checkpoint directory: those its
    ``model.safetensors.index.json`` names (in their order of first
    appearance), else every ``*.safetensors`` file, sorted."""
    ckpt_dir = Path(ckpt_dir)
    index = ckpt_dir / INDEX_FILENAME
    if not index.exists():
        return sorted(ckpt_dir.glob("*.safetensors"))
    weight_map = json.loads(index.read_text())["weight_map"]
    files = list(dict.fromkeys(weight_map.values()))
    missing = [f for f in files if not (ckpt_dir / f).exists()]
    if missing:
        raise FileNotFoundError(f"{index} names shards that are not there: {missing[:3]}")
    return [ckpt_dir / f for f in files]


def iter_dir_tensors(ckpt_dir: str | os.PathLike) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` over every file of :func:`checkpoint_files`."""
    for path in checkpoint_files(ckpt_dir):
        reader = SafetensorsFile(path)
        for name in reader.keys():
            yield name, reader.get_tensor(name)


class StreamWriter:
    """Write one safetensors file whose tensors arrive one at a time.

    ``specs`` declares ``(name, dtype, shape)`` of every tensor, in the
    order :meth:`write` will receive them; the header is written at once,
    and :meth:`close` checks that every declared tensor came."""

    def __init__(self, path: str | os.PathLike,
                 specs: Iterable[tuple[str, torch.dtype, Iterable[int]]],
                 metadata: Mapping[str, str] | None = None):
        self.path = Path(path)
        header: dict = {}
        if metadata:
            header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
        self._order: list[tuple[str, torch.dtype, list[int]]] = []
        offset = 0
        for name, dtype, shape in specs:
            shape = [int(d) for d in shape]
            if name in header:
                raise ValueError(f"tensor {name!r} declared twice")
            end = offset + _nbytes(dtype, shape)
            header[name] = {"dtype": CODES[dtype], "shape": shape, "data_offsets": [offset, end]}
            self._order.append((name, dtype, shape))
            offset = end
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)
        self._next = 0
        self._file = open(self.path, "wb")
        self._file.write(struct.pack("<Q", len(raw)))
        self._file.write(raw)
        self.nbytes = 8 + len(raw) + offset

    def write(self, name: str, tensor: torch.Tensor) -> None:
        """Append the next declared tensor (any device; its dtype and
        shape must be the declared ones)."""
        if self._next >= len(self._order):
            raise ValueError(f"tensor {name!r} was not declared")
        want, dtype, shape = self._order[self._next]
        if name != want or tensor.dtype != dtype or list(tensor.shape) != shape:
            raise ValueError(f"expected {want!r} {dtype} {shape}, got {name!r} "
                             f"{tensor.dtype} {list(tensor.shape)}")
        if tensor.numel():
            # contiguous on the tensor's own device, then one copy to the host
            host = tensor.detach().contiguous().to("cpu").reshape(-1)
            self._file.write(memoryview(host.view(torch.uint8).numpy()))
        self._next += 1

    def close(self) -> None:
        if self._file is None:
            return
        self._file.close()
        self._file = None
        if self._next != len(self._order):
            raise ValueError(f"{self.path}: {len(self._order) - self._next} declared tensors "
                             f"were never written, first {self._order[self._next][0]!r}")

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        elif self._file is not None:
            self._file.close()
            self._file = None

