"""ctypes bindings for the native JSONL packer (``csrc/packer.cc``).

The parse+tokenize+pack hot path runs in C++; shuffling and batch assembly
stay in ``data.loader`` (numpy).  Covers every byte-level row schema —
plain LM, SFT prompt/completion (text or tokens), and chat messages, with
loss flags — and gives the same blocks as ``loader.load_token_documents`` +
``loader.pack_documents`` (the tests hold the two to bit equality).  Rows
needing a real tokenizer file keep using the Python path.

The library is built by the host route of ``ops/kernels/build.py`` into the
checkout's ``build/torch_kernels/`` at first use.  A build or load failure
raises with the compiler's output: nothing falls back to Python quietly.
``FTC_NATIVE=0`` opts out, and :func:`pack_jsonl_native` then returns None.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

#: packs that went through the library since import (the trainer's log and
#: the card run read it to show which path a job took)
packs_total = 0


@functools.cache
def _library() -> ctypes.CDLL:
    from ..ops.kernels.build import load_host

    lib = load_host("packer")
    lib.ftc_pack_file.restype = ctypes.c_int64
    lib.ftc_pack_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)
    ]
    lib.ftc_copy_packed.restype = ctypes.c_int32
    lib.ftc_copy_packed.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int32)] * 3
    lib.ftc_last_error.restype = ctypes.c_char_p
    lib.ftc_free.argtypes = [ctypes.c_void_p]
    return lib


def pack_jsonl_native(
    path: str, seq_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Native parse+tokenize+pack; None when ``FTC_NATIVE`` opts out.

    Returns (tokens, segments, loss_flags).  Raises ValueError on a row the
    packer cannot own (the Python loader then decides, as in the reference),
    RuntimeError when the library cannot be built or loaded.
    """
    global packs_total
    if os.environ.get("FTC_NATIVE", "1").strip().lower() in ("0", "false", "no"):
        return None
    lib = _library()
    handle = ctypes.c_void_p()
    n_blocks = lib.ftc_pack_file(os.fsencode(path), seq_len, ctypes.byref(handle))
    if n_blocks < 0:
        err = lib.ftc_last_error().decode(errors="replace")
        raise ValueError(f"native packer failed for {path}: {err}")
    try:
        out = [np.empty((n_blocks, seq_len), np.int32) for _ in range(3)]
        rc = lib.ftc_copy_packed(
            handle, *(a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for a in out)
        )
        if rc != 0:
            raise ValueError("native packer copy failed")
    finally:
        lib.ftc_free(handle)
    packs_total += 1
    tokens, segments, flags = out
    return tokens, segments, flags.astype(np.float32)
