"""Attention functions of the port (counterpart of ``ops/attention.py``).

The plain functions repeat the reference's numerics step for step: the
score einsum runs in the storage dtype, is cast to f32, masked with the f32
minimum (so ``exp`` underflows to an exact 0.0 and masked slots contribute
nothing), soft-maxed in f32, cast to the V dtype, and contracted with V in
the storage dtype.

``paged_cache_attention`` is the one seam every paged attention call of the
engine goes through.  ``FTC_PAGED_ATTN`` selects its path:

* ``auto`` (default) — the gate of ``ops/kernel_bench.py``
  (:func:`~.kernel_bench.preferred_impl`): the CUDA kernel for CUDA
  tensors, the plain gather path for CPU tensors;
* ``kernel`` — the CUDA kernel; raises for CPU tensors;
* ``gather`` — the plain gather path on any device (operator override).

There is no size-based fallback from the kernel to the gather path on the
card: the kernel walks any lane length.

``causal_attention`` is the training path's seam and follows
``cfg.attention_impl``: ``xla`` is :func:`xla_causal_attention`; ``pallas``
and ``auto`` are the flash path (``ops/kernels/flash_attention.py``), whose
choice ``FTC_FLASH_ATTN`` makes:

* ``auto`` (default) — the gate of ``ops/kernel_bench.py``
  (:func:`~.kernel_bench.preferred_impl`, as the reference's ``auto``
  consults its bench): the CUDA kernels for CUDA tensors at every length
  (the JAX package's 1024-token crossover was measured on a TPU), the
  plain version for CPU tensors;
* ``kernel`` — the CUDA kernels; raises for CPU tensors;
* ``plain`` — the plain version on any device (operator override).

``ring`` and ``ulysses`` shard the sequence over an ``sp`` mesh axis in
the reference; the port has none (``train.cli.check_mesh`` refuses
``sp > 1``), so both run :func:`xla_causal_attention`, as the reference
does when no ``sp`` axis is active.
"""

from __future__ import annotations

import os

import torch

_F32_MIN = torch.finfo(torch.float32).min


def xla_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float | None = None,
                         segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Causal (optionally segment-masked) GQA attention.

    q (B, S, H, D); k, v (B, S, Hkv, D) with H % Hkv == 0.  Returns
    (B, S, H, D) in v's dtype."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qh = (q * scale).reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qh, k).to(torch.float32)
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :])[None, None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, None, :, None] == segment_ids[:, None, None, None, :]
        mask = mask & seg
    scores = scores.masked_fill(~mask, _F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def chunked_cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, idx) -> torch.Tensor:
    """A chunk of S query tokens against a static-length KV cache.

    q (B, S, H, D); caches (B, M, Hkv, D); ``idx`` is the absolute position
    of the chunk's first query token, a scalar or (B,).  Query j attends
    cache slots ``<= idx + j``."""
    b, s, h, d = q.shape
    hkv = k_cache.shape[2]
    qh = (q * d ** -0.5).reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qh, k_cache).to(torch.float32)
    idx = torch.as_tensor(idx, device=q.device)
    if idx.ndim:  # (B,) per-row positions -> broadcast over (b, k, g, s, t)
        idx = idx.reshape(b, 1, 1, 1, 1)
    qpos = idx + torch.arange(s, device=q.device).reshape(1, 1, 1, s, 1)
    valid = torch.arange(k_cache.shape[1], device=q.device).reshape(1, 1, 1, 1, -1) <= qpos
    scores = scores.masked_fill(~valid, _F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_cache)
    return out.reshape(b, s, h, d)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Per-lane logical caches (B, MP*T, Hkv, D) gathered from a (P, T, Hkv,
    D) pool through a (B, MP) page table.  Unmaterialized table slots point
    at the scratch page 0; what they gather lies past the lane's index and
    is masked to an exact-zero softmax contribution."""
    b, mp = page_table.shape
    _, t, hkv, d = pool.shape
    return pool[page_table.long()].reshape(b, mp * t, hkv, d)


def paged_attention_impl(q: torch.Tensor) -> str:
    """Resolve ``FTC_PAGED_ATTN`` for a call with query ``q``: ``kernel``
    or ``gather``."""
    raw = os.environ.get("FTC_PAGED_ATTN") or "auto"
    impl = raw.strip().lower()
    if impl not in ("auto", "kernel", "gather"):
        raise ValueError(f"FTC_PAGED_ATTN={raw!r}: expected auto, kernel or gather")
    if impl == "auto":
        from .kernel_bench import preferred_impl

        return "kernel" if preferred_impl(q.shape[1], q.device) == "kernel" else "gather"
    if impl == "kernel" and not q.is_cuda:
        raise ValueError(
            "FTC_PAGED_ATTN=kernel needs CUDA tensors; the paged-attention "
            f"kernel does not run on {q.device.type}"
        )
    return impl


def paged_cache_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          idx) -> torch.Tensor:
    """:func:`chunked_cache_attention` reading through a page table.

    q (B, S, H, D); pools (P, T, Hkv, D); ``page_table`` (B, MP) int32;
    ``idx`` scalar or (B,).  S = 1 is the decode step, S > 1 a
    (bucket-padded) prefill or suffix prefill."""
    if paged_attention_impl(q) == "kernel":
        from .kernels.paged_attention import paged_attention

        return paged_attention(q, k_pool, v_pool, page_table, idx)
    return chunked_cache_attention(
        q, paged_gather(k_pool, page_table), paged_gather(v_pool, page_table), idx
    )


def flash_attention_impl(q: torch.Tensor) -> str:
    """Resolve ``FTC_FLASH_ATTN`` for a call with query ``q``: ``kernel``
    or ``plain``."""
    raw = os.environ.get("FTC_FLASH_ATTN") or "auto"
    impl = raw.strip().lower()
    if impl not in ("auto", "kernel", "plain"):
        raise ValueError(f"FTC_FLASH_ATTN={raw!r}: expected auto, kernel or plain")
    if impl == "auto":
        from .kernel_bench import preferred_impl

        return preferred_impl(q.shape[1], q.device)
    if impl == "kernel" and not q.is_cuda:
        raise ValueError(
            "FTC_FLASH_ATTN=kernel needs CUDA tensors; the flash-attention "
            f"kernels do not run on {q.device.type}"
        )
    return impl


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     impl: str = "xla",
                     segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA attention of the training forward, dispatched on
    ``impl`` (``cfg.attention_impl``).  q (B, S, H, D); k, v (B, S, Hkv,
    D); ``segment_ids`` (B, S) keeps packed documents apart."""
    if impl == "xla":
        return xla_causal_attention(q, k, v, segment_ids=segment_ids)
    if impl in ("pallas", "auto"):
        from .kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, segment_ids=segment_ids,
                               plain=flash_attention_impl(q) == "plain")
    if impl in ("ring", "ulysses"):
        # no sequence-parallel axis exists in the port (train.cli refuses a
        # mesh with sp > 1): plain attention, as the reference runs when no
        # sp axis is active
        return xla_causal_attention(q, k, v, segment_ids=segment_ids)
    raise ValueError(f"unknown attention impl: {impl!r}")
