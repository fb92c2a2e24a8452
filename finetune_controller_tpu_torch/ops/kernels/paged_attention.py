"""Paged-cache attention: the CUDA kernel's wrapper and its plain version.

Replaces ``finetune_controller_tpu/ops/pallas/paged_attention.py::
_paged_kernel`` (the Pallas TPU kernel).  The kernel source is
``csrc/paged_attention.cu``; its note gives the design.  In short:

* what bounds it on the H100 is the bytes of the live KV pages (each
  attended K/V row is read once; 2·D FMAs per row and query head is far
  below the card's operations-per-byte balance point);
* one thread block per (query tile, KV head, lane) walks the lane's page
  table itself, loads each attended K/V row into shared memory once for all
  query heads of the GQA group, skips pages past ``idx + S - 1`` entirely,
  and keeps an online softmax in f32.

The TPU kernel is bit-identical to the gather oracle because it replays the
oracle's op sequence on a VMEM copy of the lane's whole cache; that copy does
not fit shared memory here, and an online softmax rounds differently.  The
kernel is held to a stated tolerance against :func:`paged_attention_reference`
instead (``TOLERANCE``; PERF.md, "Tolerance").

:func:`paged_attention` launches the kernel for CUDA tensors and counts each
launch in ``paged_attention.launches``; for CPU tensors it runs the plain
version.  There is no fallback from the kernel: a CUDA call launches it or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..attention import chunked_cache_attention, paged_gather

#: kernel vs plain version, (atol, rtol) by storage dtype.  f32: only the
#: summation order and the online rescaling differ.  bf16: the plain path
#: rounds scores and probabilities to bf16 before the PV product and the
#: output to bf16 (2^-8 relative), the kernel keeps them in f32 — so one or
#: two bf16 ulps of an output of magnitude ~1.
TOLERANCE = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def paged_attention_reference(q, k_pool, v_pool, page_table, idx) -> torch.Tensor:
    """The plain version: gather each lane's logical cache through the page
    table, then :func:`~..attention.chunked_cache_attention`."""
    return chunked_cache_attention(
        q, paged_gather(k_pool, page_table), paged_gather(v_pool, page_table), idx
    )


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load

    lib = load("paged_attention")
    fn = lib.ftc_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ftc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ftc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    page_table: torch.Tensor, idx) -> torch.Tensor:
    """Attention of q (B, S, H, D) over pools (P, T, Hkv, D) read through
    ``page_table`` (B, MP) int32 from cache index ``idx`` (scalar or (B,)):
    query j of lane b attends logical positions ``<= idx[b] + j``.  Returns
    (B, S, H, D) in the pool dtype."""
    if q.dtype != k_pool.dtype or q.dtype != v_pool.dtype:
        raise ValueError(
            f"paged_attention: q/k/v dtypes must match (got {q.dtype}, "
            f"{k_pool.dtype}, {v_pool.dtype}); use the gather path for mixed dtypes"
        )
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table, idx)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    b, s, h, d = q.shape
    p, t, hkv, dk = k_pool.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_attention: dtype {q.dtype} unsupported (float32, bfloat16)")
    if d not in _HEAD_DIMS or dk != d or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_attention: head dim must be one of {_HEAD_DIMS} and match "
            f"the pools (q {tuple(q.shape)}, k {tuple(k_pool.shape)}, v {tuple(v_pool.shape)})"
        )
    if h % hkv:
        raise ValueError(f"paged_attention: {h} query heads not a multiple of {hkv} KV heads")
    if page_table.ndim != 2 or page_table.shape[0] != b:
        raise ValueError(f"paged_attention: page table {tuple(page_table.shape)} for batch {b}")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be a contiguous, "
                             f"16-byte aligned tensor on {q.device}")
    q = q.contiguous()
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    idx = torch.as_tensor(idx, device=q.device, dtype=torch.int32).reshape(-1)
    idx = idx.expand(b).contiguous()
    out = torch.empty((b, s, h, d), dtype=v_pool.dtype, device=q.device)
    lib = _library()
    err = lib.ftc_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), out.data_ptr(), b, s, h, hkv, d, t, table.shape[1],
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            "paged_attention kernel launch failed: "
            + lib.ftc_cuda_error_string(err).decode()
        )
    paged_attention.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (plain CPU calls excluded)
paged_attention.launches = 0
