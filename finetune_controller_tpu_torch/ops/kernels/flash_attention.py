"""Flash attention for training: the CUDA kernels' wrappers, their plain
versions and the ``torch.autograd.Function`` that ties them together.

Replaces the three Pallas TPU kernels of
``finetune_controller_tpu/ops/pallas/flash_attention.py`` (``_fwd_kernel``,
``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) and their ``custom_vjp``.  The
kernel source is ``csrc/flash_attention.cu`` (with the Hopper building
blocks of ``csrc/sm90.cuh``); its note gives the design.  In short:

* what bounds them on the H100 is operations (2·D FLOP per attended
  (query, key) pair and product, on tiles reused from shared memory);
* one block per (query tile, head, batch row) for the forward and dQ, one per
  (key tile, KV head, batch row) for dK/dV, which sums the GQA group inside
  the block (no atomics: deterministic); ragged tails are masked in the
  kernel, nothing is padded;
* the three bf16 kernels are Hopper kernels: a producer warp streams tiles
  by TMA through a ring of shared-memory stages, consumer warpgroups run
  ``wgmma`` on them, and tile pairs that :func:`live_tiles` marks dead (past
  the causal frontier, or documents that cannot meet) are skipped; dQ keeps
  its 128 query rows of Q and dO resident and streams K and V, computing
  S = Q·Kᵀ and dP = dO·Vᵀ together and dQ += dS·K with dS kept in
  registers; no kernel uses atomics, so two launches give the same bits;
  head dims 64, 128 and 256, the last with tiles of its own (:data:`TILES`;
  its dK/dV splits D across the two consumer warpgroups);
* f32 products run as FMAs on the CUDA cores.

Layouts are the reference's: q, out, dO (B, S, H, D); k, v (B, S, Hkv, D);
segment ids (B, S) int32; ``lse`` and ``delta`` (B, H, S) f32 here, with
:func:`flash_attention_with_lse` returning lse as (B, H, S, 1) like the JAX
function.

Each wrapper (:func:`flash_forward`, :func:`flash_backward_dq`,
:func:`flash_backward_dkv`) launches its kernel for CUDA tensors and counts
the launch in its ``launches`` attribute; for CPU tensors it runs the plain
version.  There is no fallback from the kernel: a CUDA call launches it or
raises (unsupported dtype or head dim, build error, launch error).
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: kernel vs plain version, (atol, rtol) by dtype.  f32: the two differ only
#: in summation order over up to S keys (and the G heads of a group for
#: dK/dV), and in the online rescaling of the forward.  bf16: both round
#: outputs to bf16 (2^-8 relative) and round p and ds to bf16 before the
#: products, but from f32 values summed in different orders, so a value on a
#: rounding boundary may land one bf16 ulp apart; the kernel takes exp in f32
#: like the plain version (the JAX package's bf16 default takes it in bf16,
#: ``_resolve_tuning``), so no exp rounding differs.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}

_NEG_INF = torch.finfo(torch.float32).min
_L_FLOOR = 1e-30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


_TILES_UP_TO_128 = {"flash_forward": (128, 128), "flash_backward_dq": (128, 64),
                    "flash_backward_dkv": (64, 128)}
#: (query tile, key tile) of each bf16 kernel by head dim: the tile pairs it
#: computes are those :func:`live_tiles` marks at these sizes.  D = 256 has
#: tiles of its own (the D <= 128 rings do not fit its shared memory and
#: registers; ``csrc/flash_attention.cu`` above ``namespace wg``).
TILES = {64: _TILES_UP_TO_128, 128: _TILES_UP_TO_128,
         256: {"flash_forward": (128, 64), "flash_backward_dq": (64, 64),
               "flash_backward_dkv": (64, 64)}}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _segments(segment_ids, kv_segment_ids, b, s, device):
    """(query ids, key ids) or (None, None): either given fills the other
    with zeros for the queries, or with the query ids for the keys."""
    if segment_ids is None and kv_segment_ids is None:
        return None, None
    if segment_ids is None:
        segment_ids = torch.zeros((b, s), dtype=torch.int32, device=device)
    if kv_segment_ids is None:
        kv_segment_ids = segment_ids
    return segment_ids.to(torch.int32), kv_segment_ids.to(torch.int32)


def _live(s, device, qseg, kseg, causal):
    """(B|1, 1, 1, S, S) mask of live (query, key) pairs."""
    pos = torch.arange(s, device=device)
    if causal:
        mask = (pos[:, None] >= pos[None, :])[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, s, s), dtype=torch.bool, device=device)
    if qseg is not None:
        mask = mask & (qseg[:, None, None, :, None] == kseg[:, None, None, None, :])
    return mask


def live_tiles(segment_ids, kv_segment_ids, tile_q: int, tile_k: int,
               causal: bool) -> torch.Tensor:
    """(B, ⌈S/tile_q⌉, ⌈S/tile_k⌉) bool: the (query tile, key tile) pairs
    that can hold a live (query, key) pair.  A pair is dead when its first
    key lies past the query tile's last query (causal), or when the query
    tile's [min, max] segment id and the key tile's are disjoint — which
    holds for any ids, monotone or not.  The bf16 Hopper kernels compute the
    same predicate and skip dead pairs; every live pair of :func:`_live`
    lies in a live tile pair.  Either id tensor may be None (as in
    :func:`_segments`), not both."""
    if segment_ids is None and kv_segment_ids is None:
        raise ValueError("live_tiles needs segment ids for the batch shape")
    ref = segment_ids if segment_ids is not None else kv_segment_ids
    b, s = ref.shape
    qseg, kseg = _segments(segment_ids, kv_segment_ids, b, s, ref.device)

    def ranges(ids, tile):
        n = -(-s // tile)
        pad = n * tile - s
        info = torch.iinfo(torch.int32)
        lo = torch.cat([ids, ids.new_full((b, pad), info.max)], 1).view(b, n, tile).amin(-1)
        hi = torch.cat([ids, ids.new_full((b, pad), info.min)], 1).view(b, n, tile).amax(-1)
        return lo, hi

    qlo, qhi = ranges(qseg, tile_q)
    klo, khi = ranges(kseg, tile_k)
    live = (qlo[:, :, None] <= khi[:, None, :]) & (klo[:, None, :] <= qhi[:, :, None])
    if causal:
        q_last = torch.clamp(torch.arange(qlo.shape[1], device=ref.device) * tile_q + tile_q,
                             max=s) - 1
        k_first = torch.arange(klo.shape[1], device=ref.device) * tile_k
        live &= (k_first[None, :] <= q_last[:, None])[None]
    return live


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded through ``dtype`` and back to f32 (the kernels' p/ds cast)."""
    return x.to(dtype).to(torch.float32)


def _grouped(q, k):
    """q as f32 (B, S, Hkv, G, D) and k as f32, with the scores (B, Hkv, G,
    S, S) = q·kᵀ·D^-0.5."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.to(torch.float32).reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.to(torch.float32)) * d ** -0.5
    return qg, scores


def flash_forward_reference(q, k, v, segment_ids=None, kv_segment_ids=None,
                            causal: bool = True):
    """The plain forward: (out (B, S, H, D) in q's dtype, lse (B, H, S) f32).
    f32 scores and exp, p rounded to v's dtype for the PV product; a fully
    masked row gives out 0 and lse = f32_min + log(1e-30)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qseg, kseg = _segments(segment_ids, kv_segment_ids, b, s, q.device)
    _, scores = _grouped(q, k)
    mask = _live(s, q.device, qseg, kseg, causal)
    scores = scores.masked_fill(~mask, _NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(_L_FLOOR)          # (B, Hkv, G, S, 1)
    pv = torch.einsum("bkgqt,btkd->bqkgd", _round(p, v.dtype), v.to(torch.float32))
    out = (pv / l.permute(0, 3, 1, 2, 4)).reshape(b, s, h, d).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return out, lse


def flash_delta(out, dout, dlse=None) -> torch.Tensor:
    """delta (B, H, S) f32 = rowsum(dO·O) − dlse: the backward's row term with
    the lse cotangent folded in (``_flash_backward`` ``:521-529``)."""
    delta = (dout.to(torch.float32) * out.to(torch.float32)).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.to(torch.float32)
    return delta.contiguous()


def _backward_plain(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids, causal):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qseg, kseg = _segments(segment_ids, kv_segment_ids, b, s, q.device)
    qg, scores = _grouped(q, k)
    mask = _live(s, q.device, qseg, kseg, causal)
    p = torch.where(mask, torch.exp(scores - lse.reshape(b, hkv, g, s, 1)), 0.0)
    dog = dout.to(torch.float32).reshape(b, s, hkv, g, d)
    dp = torch.einsum("bqkgd,btkd->bkgqt", dog, v.to(torch.float32))
    ds = _round(p * (dp - delta.reshape(b, hkv, g, s, 1)), k.dtype)
    scale = d ** -0.5
    dq = torch.einsum("bkgqt,btkd->bqkgd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bkgqt,bqkgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgqt,bqkgd->btkd", _round(p, v.dtype), dog)
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, out, lse, dout, dlse=None, segment_ids=None,
                             kv_segment_ids=None, causal: bool = True):
    """The plain backward: (dq, dk, dv) from p = exp(s − lse) recomputed,
    ds = p·(dp − delta) with delta = rowsum(dO·O) − dlse."""
    delta = flash_delta(out, dout, dlse)
    return _backward_plain(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids, causal)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    from .build import load

    lib = load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 7 + [ctypes.c_float, ptr]  # B S H Hkv D causal dtype, scale, stream
    for name, n_ptrs in (("ftc_flash_fwd", 7), ("ftc_flash_bwd_dq", 9),
                         ("ftc_flash_bwd_dkv", 10)):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * n_ptrs + tail
        fn.restype = i32
    lib.ftc_flash_error_string.argtypes = [i32]
    lib.ftc_flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, q, k, v, *more):
    """Validate what the kernels take; returns the shape tuple."""
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share one dtype of float32, bfloat16 "
                         f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} unsupported by the kernel ({_HEAD_DIMS})")
    if k.ndim != 4 or k.shape[:2] != (b, s) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"{name}: {h} query heads not a multiple of {hkv} KV heads")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    for x in (q, k, v, *more):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name}: every tensor must lie on {q.device}")
    return b, s, h, hkv, d


def _seg_args(segment_ids, kv_segment_ids, b, s, device):
    qseg, kseg = _segments(segment_ids, kv_segment_ids, b, s, device)
    if qseg is None:
        return None, None
    for x in (qseg, kseg):
        if tuple(x.shape) != (b, s):
            raise ValueError(f"segment ids {tuple(x.shape)} for batch ({b}, {s})")
    return qseg.to(device).contiguous(), kseg.to(device).contiguous()


def _dense(*xs):
    """Each tensor contiguous and 16-byte aligned (the TMA loads need it)."""
    return tuple(x if x.is_contiguous() and x.data_ptr() % 16 == 0
                 else x.clone(memory_format=torch.contiguous_format) for x in xs)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _library().ftc_flash_error_string(err).decode())


def flash_forward(q, k, v, segment_ids=None, kv_segment_ids=None, causal: bool = True):
    """(out (B, S, H, D), lse (B, H, S) f32): the forward kernel on CUDA
    tensors, :func:`flash_forward_reference` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, segment_ids, kv_segment_ids, causal)
    b, s, h, hkv, d = _check("flash_forward", q, k, v)
    q, k, v = _dense(q, k, v)
    qseg, kseg = _seg_args(segment_ids, kv_segment_ids, b, s, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _library().ftc_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg), out.data_ptr(),
        lse.data_ptr(), b, s, h, hkv, d, int(causal), _DTYPE_CODE[q.dtype], d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_forward")
    flash_forward.launches += 1
    return out, lse


def flash_backward_dq(q, k, v, dout, lse, delta, segment_ids=None, kv_segment_ids=None,
                      causal: bool = True):
    """dq (B, S, H, D): the dQ kernel on CUDA tensors, the plain backward on
    CPU tensors.  ``lse`` and ``delta`` are (B, H, S) f32."""
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids,
                               causal)[0]
    b, s, h, hkv, d = _check("flash_backward_dq", q, k, v, dout, lse, delta)
    q, k, v, dout = _dense(q, k, v, dout)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    qseg, kseg = _seg_args(segment_ids, kv_segment_ids, b, s, q.device)
    dq = torch.empty_like(q)
    err = _library().ftc_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(qseg), _ptr(kseg), dq.data_ptr(), b, s, h, hkv, d,
        int(causal), _DTYPE_CODE[q.dtype], d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta, segment_ids=None, kv_segment_ids=None,
                       causal: bool = True):
    """(dk, dv), each (B, S, Hkv, D): the dK/dV kernel on CUDA tensors, the
    plain backward on CPU tensors."""
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, dout, lse, delta, segment_ids, kv_segment_ids,
                               causal)[1:]
    b, s, h, hkv, d = _check("flash_backward_dkv", q, k, v, dout, lse, delta)
    q, k, v, dout = _dense(q, k, v, dout)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    qseg, kseg = _seg_args(segment_ids, kv_segment_ids, b, s, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _library().ftc_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(qseg), _ptr(kseg), dk.data_ptr(), dv.data_ptr(), b, s, h,
        hkv, d, int(causal), _DTYPE_CODE[q.dtype], d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    return dk, dv


#: launches of each CUDA kernel since the last reset (plain CPU calls excluded)
flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` with both outputs differentiable, mirroring the
    reference's ``custom_vjp`` (``_flash_attention_lse``).  The forward saves
    q, k, v, the segment ids, out and lse; the backward folds the lse
    cotangent into delta and runs the dQ and dK/dV kernels.  ``plain`` runs
    the plain versions on any device (``FTC_FLASH_ATTN=plain``).
    ``forwards`` counts the Function's forwards on either path (a
    rematerialised segment that holds the Function runs it again), beside
    the kernels' launch counts."""

    forwards = 0

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, causal: bool, plain: bool):
        FlashAttention.forwards += 1
        fwd = flash_forward_reference if plain else flash_forward
        out, lse = fwd(q, k, v, segment_ids, kv_segment_ids, causal)
        ctx.save_for_backward(q, k, v, segment_ids, kv_segment_ids, out, lse)
        ctx.causal, ctx.plain = causal, plain
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, seg, kvseg, out, lse = ctx.saved_tensors
        delta = flash_delta(out, dout, dlse)
        if ctx.plain:
            dq, dk, dv = _backward_plain(q, k, v, dout, lse, delta, seg, kvseg, ctx.causal)
        else:
            dq = flash_backward_dq(q, k, v, dout, lse, delta, seg, kvseg, ctx.causal)
            dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, seg, kvseg, ctx.causal)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, *, segment_ids=None, kv_segment_ids=None,
                             causal: bool = True, plain: bool = False):
    """``(out (B, S, H, D), lse (B, H, S, 1) f32)``, both differentiable — the
    counterpart of the reference's ``flash_attention_with_lse``."""
    out, lse = FlashAttention.apply(q, k, v, segment_ids, kv_segment_ids, causal, plain)
    return out, lse.unsqueeze(-1)


def flash_attention(q, k, v, *, segment_ids=None, plain: bool = False) -> torch.Tensor:
    """Causal GQA flash attention, shapes as ``ops.attention.causal_attention``."""
    return FlashAttention.apply(q, k, v, segment_ids, None, True, plain)[0]
