"""Paged-cache attention: the CUDA kernels' wrapper and its plain version.

Replaces ``finetune_controller_tpu/ops/pallas/paged_attention.py::
_paged_kernel`` (the Pallas TPU kernel).  The kernel source is
``csrc/paged_attention.cu``; its note gives the design.  In short:

* what bounds it on the H100 is the bytes of the attended K/V rows (each is
  read once; 2·D FMAs per row and query head is far below the card's
  operations-per-byte balance point), so the card needs many blocks with
  many loads in flight;
* rows are the flat (query, head-of-group) rows of a (KV head, lane), so a
  K/V row read once serves every query head of the GQA group; blocks read
  the page table themselves and stop at the causal frontier ``idx + S - 1``;
* the key range is split across :func:`paged_splits` blocks
  (flash-decoding) where the rows alone give too few blocks, as in decode;
  each block writes an f32 partial and a second kernel combines them in
  fixed order;
* bf16 runs on the tensor cores (``mma.sync``), K/V pages double-buffered
  by ``cp.async``: decode (at most :data:`DECODE_ROWS` rows per (KV head,
  lane)) shares one 16-row tile among the warps of a block, which split the
  keys; prefill gives each warp its own 16 rows.  f32 runs on the CUDA
  cores.

The TPU kernel is bit-identical to the gather oracle because it replays the
oracle's op sequence on a VMEM copy of the lane's whole cache; that copy does
not fit shared memory here, and an online softmax rounds differently.  The
kernel is held to a stated tolerance against :func:`paged_attention_reference`
instead (``TOLERANCE``).

:func:`paged_attention` launches the kernel for CUDA tensors and counts each
call in ``paged_attention.launches``; for CPU tensors it runs the plain
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

#: flat (query, head-of-group) rows per (KV head, lane), S·G, up to which
#: bf16 runs the decode design, the key range split across blocks; above it
#: the prefill design, one split (``DECODE_ROWS`` in
#: ``csrc/paged_attention.cu``).  f32 splits at any S·G.
DECODE_ROWS = 16
#: fewest positions a split should walk (4 pages of 16), and most splits
_MIN_SPLIT = 64
_MAX_SPLITS = 32


def _prefill(rows: int, dtype) -> bool:
    return dtype == torch.bfloat16 and rows > DECODE_ROWS


def paged_splits(b: int, s: int, h: int, hkv: int, positions: int, dtype,
                 sms: int = 132) -> int:
    """How many parts the kernel cuts each row tile's key range into: enough
    blocks for two per SM (``sms`` of them), each with at least
    ``_MIN_SPLIT`` of the ``positions`` the longest range can hold.  1 for
    bf16 prefill (above :data:`DECODE_ROWS` rows), which does not split.
    The kernel splits each lane's own range evenly, so on a short lane the
    last splits are empty and return at once."""
    rows = s * (h // hkv)
    if _prefill(rows, dtype):
        return 1
    if dtype == torch.bfloat16:
        per_block = 16  # the kernels' row tiles: see csrc/paged_attention.cu
    else:
        per_block = 4 if rows <= 4 else 8 if rows <= 8 else 16
    blocks = b * hkv * -(-rows // per_block)
    want = -(-2 * sms // blocks)
    return max(1, min(want, positions // _MIN_SPLIT, _MAX_SPLITS))


def paged_attention_reference(q, k_pool, v_pool, page_table, idx) -> torch.Tensor:
    """The plain version: gather each lane's logical cache through the page
    table, then :func:`~..attention.chunked_cache_attention`."""
    return chunked_cache_attention(
        q, paged_gather(k_pool, page_table), paged_gather(v_pool, page_table), idx
    )


def _int32_on(x: torch.Tensor, device) -> torch.Tensor:
    """x as a contiguous int32 tensor on ``device`` (itself when it is one:
    the decode step calls this per layer, so the check is host-cheap)."""
    if x.dtype == torch.int32 and x.device == device and x.is_contiguous():
        return x
    return x.to(device=device, dtype=torch.int32).contiguous()


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load

    lib = load("paged_attention")
    fn = lib.ftc_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ftc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ftc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    page_table: torch.Tensor, idx, *, splits: int | None = None) -> torch.Tensor:
    """Attention of q (B, S, H, D) over pools (P, T, Hkv, D) read through
    ``page_table`` (B, MP) int32 from cache index ``idx`` (scalar or (B,)):
    query j of lane b attends logical positions ``<= idx[b] + j``.  Returns
    (B, S, H, D) in the pool dtype.

    On the card the kernel cuts the key range into ``splits`` parts
    (default :func:`paged_splits` over the table's MP·T positions: ``idx``
    lives on the card, and reading it would stall the host; the bf16
    prefill ignores it); the f32 partials go to a workspace this call
    allocates.  One call counts as one launch in
    ``paged_attention.launches``, also when a second kernel combines the
    partials."""
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
    table = _int32_on(page_table, q.device)
    if not (isinstance(idx, torch.Tensor) and idx.shape == (b,)):  # a scalar
        idx = torch.as_tensor(idx, device=q.device, dtype=torch.int32).reshape(-1).expand(b)
    idx = _int32_on(idx, q.device)
    mp = table.shape[1]
    if splits is not None and splits < 1:
        raise ValueError(f"paged_attention: splits must be >= 1 (got {splits})")
    if splits is None or _prefill(s * (h // hkv), q.dtype):
        n = paged_splits(b, s, h, hkv, mp * t, q.dtype, _sm_count(q.device))
    else:
        n = splits
    out = torch.empty((b, s, h, d), dtype=v_pool.dtype, device=q.device)
    ws_ml = ws_acc = None
    if n > 1:  # partials: (B, Hkv, n, S·G) (max, sum) pairs, then as many D-vectors
        parts = b * hkv * n * s * (h // hkv)
        ws = torch.empty(parts * (2 + d), dtype=torch.float32, device=q.device)
        ws_ml, ws_acc = ws.data_ptr(), ws.data_ptr() + parts * 2 * ws.element_size()
    lib = _library()
    err = lib.ftc_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        idx.data_ptr(), out.data_ptr(), ws_ml, ws_acc, b, s, h, hkv, d, t, mp,
        _DTYPE_CODE[q.dtype], n, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            "paged_attention kernel launch failed: "
            + lib.ftc_cuda_error_string(err).decode()
        )
    paged_attention.launches += 1
    return out


#: calls that launched the CUDA kernels since the last reset (plain CPU calls
#: excluded; a split call with its combine counts once)
paged_attention.launches = 0
