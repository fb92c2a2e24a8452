"""Attention micro-benchmark and the ``auto`` dispatch gate.

Counterpart of the reference's ``ops/kernel_bench.py``.  The measurement is
the reference's: per-call seconds of the forward and of the gradient
(forward + backward) at a given shape, each call's output chained into the
next call's query (:func:`_time_chained`), so no call is skipped, cached or
overlapped with the next.  The impls are the port's:

* ``kernel`` — the CUDA kernels (``ops/kernels/flash_attention.py``, the
  paged kernel of ``ops/kernels/paged_attention.py``); CUDA tensors only;
* ``plain`` / ``gather`` — the plain PyTorch versions the kernels are held
  against;
* ``sdpa`` — ``torch.nn.functional.scaled_dot_product_attention``, a
  yardstick only: no route of the port runs it.

:func:`preferred_impl` is the gate ``auto`` consults (``ops/attention.py``):
the reference's gate picks its TPU kernel above a sequence length measured
on a TPU; the port's keeps the CUDA kernels on every CUDA tensor at every
length (the plain version is never on the main path when a card is
present) and the plain version on the CPU, where no kernel runs.

Run on the card::

    python -m finetune_controller_tpu_torch.ops.kernel_bench [--seq 2048 ...]
    python -m finetune_controller_tpu_torch.ops.kernel_bench --paged-variants

Each prints one JSON line per shape.
"""

from __future__ import annotations

import time

import torch


def preferred_impl(seq_len: int, device: torch.device | str | None = None) -> str:
    """Dispatch gate for ``auto``: ``kernel`` for CUDA at every length,
    ``plain`` elsewhere.  ``seq_len`` is kept for the reference's signature;
    no length sends a CUDA tensor to the plain version."""
    del seq_len
    device = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    return "kernel" if device.type == "cuda" else "plain"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_chained(fn, q, k, v, chain, iters: int, warmup: int = 2) -> float:
    """Average per-call seconds with a data-dependency chain: each call's
    output becomes the next call's query (``chain`` maps the output and the
    previous query to a q-shaped tensor).  The chain puts every call on the
    critical path, as a training loop's state does; a host fetch of a
    dependent scalar closes each timed range."""

    def force(x):
        return float(x.float().sum())

    for _ in range(warmup):
        q = chain(fn(q, k, v), q)
    force(q)
    _sync(q.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        q = chain(fn(q, k, v), q)
    force(q)
    return (time.perf_counter() - t0) / iters


def _make_qkv(batch, seq, heads, kv_heads, head_dim, dtype, device, seed: int = 0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    shapes = ((batch, seq, heads, head_dim), (batch, seq, kv_heads, head_dim),
              (batch, seq, kv_heads, head_dim))
    return tuple(torch.randn(s, generator=g).to(device=device, dtype=dtype) for s in shapes)


def _chain_fwd(out, q_prev):
    return out.to(q_prev.dtype)


def _chain_grad(grads, q_prev):
    """Fold dQ back into the next call's q, keeping magnitudes bounded so
    the chain can run indefinitely without overflowing."""
    return q_prev + grads[0].to(q_prev.dtype) * 1e-3


def _sdpa(q, k, v):
    """The library yardstick: SDPA on (B, H, S, D) with the KV heads
    repeated to the query heads."""
    g = q.shape[2] // k.shape[2]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(g, 2).transpose(1, 2),
        v.repeat_interleave(g, 2).transpose(1, 2), is_causal=True)
    return out.transpose(1, 2)


def _flash_impls(device: torch.device, segment_ids=None) -> dict:
    from .attention import xla_causal_attention
    from .kernels.flash_attention import flash_attention

    impls = {
        "plain": lambda q, k, v: xla_causal_attention(q, k, v, segment_ids=segment_ids),
    }
    if device.type == "cuda":
        impls["kernel"] = lambda q, k, v: flash_attention(q, k, v, segment_ids=segment_ids)
    if segment_ids is None:
        impls["sdpa"] = _sdpa
    return impls


def _grad_fn(attn):
    def grad(q, k, v):
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        loss = (attn(q, k, v).float() ** 2).mean()
        return torch.autograd.grad(loss, (q, k, v))

    return grad


def bench_attention(batch: int = 2, seq: int = 2048, heads: int = 32, kv_heads: int = 8,
                    head_dim: int = 128, dtype=torch.bfloat16, iters: int = 10,
                    device: torch.device | str | None = None) -> dict[str, float]:
    """Per-call seconds for each impl, forward and grad (fwd+bwd): keys
    ``{impl}_fwd_s`` and ``{impl}_grad_s``; ``kernel`` only on a card."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    q, k, v = _make_qkv(batch, seq, heads, kv_heads, head_dim, dtype, device)
    results: dict[str, float] = {}
    for name, attn in _flash_impls(device).items():
        results[f"{name}_fwd_s"] = _time_chained(attn, q, k, v, _chain_fwd, iters)
        results[f"{name}_grad_s"] = _time_chained(_grad_fn(attn), q, k, v, _chain_grad, iters)
    return results


def bench_flash_variants(batch: int = 2, seq: int = 2048, heads: int = 32, kv_heads: int = 8,
                         head_dim: int = 128, dtype=torch.bfloat16, iters: int = 8,
                         documents: tuple[int, ...] = (1, 4),
                         device: torch.device | str | None = None) -> dict[str, float]:
    """Grad-path seconds per flash variant.  The reference sweeps its TPU
    kernel's exp dtype and block size; the port's kernels have fixed tiles,
    and what varies on the main path is the packing: ``documents`` equal
    segments per row (1 = one causal document), where the kernels skip the
    tiles no query of a segment can see.  Keys ``"{impl}-docs{n}"``."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    q, k, v = _make_qkv(batch, seq, heads, kv_heads, head_dim, dtype, device)
    results: dict[str, float] = {}
    for n in documents:
        seg = None
        if n > 1:
            seg = (torch.arange(seq, device=device) * n // seq + 1).to(torch.int32)
            seg = seg.expand(batch, seq).contiguous()
        for name, attn in _flash_impls(device, seg).items():
            results[f"{name}-docs{n}"] = _time_chained(
                _grad_fn(attn), q, k, v, _chain_grad, iters)
    return results


def bench_paged_variants(batch: int = 8, heads: int = 32, kv_heads: int = 8,
                         head_dim: int = 128, page_tokens: int = 16,
                         pages_per_lane: tuple[int, ...] = (16, 64, 256),
                         dtype=torch.bfloat16, iters: int = 20,
                         device: torch.device | str | None = None) -> dict[str, float]:
    """Decode-step seconds of the paged-attention impls, swept over pages
    per lane (context length at a fixed page size): ``gather`` materialises
    a (B, MP*T, Hkv, D) logical cache every step, the kernel reads each page
    once; ``sdpa`` attends the same keys laid out dense (the library's time
    for the function without the page table).  Keys ``"{impl}-p{pages}"``;
    ``kernel`` only on a card."""
    from .attention import chunked_cache_attention, paged_gather
    from .kernels.paged_attention import paged_attention

    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    results: dict[str, float] = {}
    g = torch.Generator(device="cpu").manual_seed(1)
    for mp in pages_per_lane:
        pool_pages = batch * mp + 1

        def rand(*shape):
            return torch.randn(shape, generator=g).to(device=device, dtype=dtype)

        q = rand(batch, 1, heads, head_dim)
        k_pool = rand(pool_pages, page_tokens, kv_heads, head_dim)
        v_pool = rand(pool_pages, page_tokens, kv_heads, head_dim)
        # each lane owns a disjoint page run, like a fragmented real pool
        table = (1 + torch.arange(batch * mp, dtype=torch.int32, device=device)).reshape(batch, mp)
        idx = torch.full((batch,), mp * page_tokens - 1, dtype=torch.int32, device=device)
        k_dense, v_dense = paged_gather(k_pool, table), paged_gather(v_pool, table)
        grp = heads // kv_heads

        def gather_step(q, k, v, table=table, idx=idx):
            return chunked_cache_attention(q, paged_gather(k, table), paged_gather(v, table), idx)

        def kernel_step(q, k, v, table=table, idx=idx):
            return paged_attention(q, k, v, table, idx)

        def sdpa_step(q, k, v, kd=k_dense, vd=v_dense):
            out = torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), kd.repeat_interleave(grp, 2).transpose(1, 2),
                vd.repeat_interleave(grp, 2).transpose(1, 2))
            return out.transpose(1, 2)

        def chain(out, q_prev):
            return q_prev + out.to(q_prev.dtype) * 1e-3

        steps = {"gather": gather_step, "sdpa": sdpa_step}
        if device.type == "cuda":
            steps["kernel"] = kernel_step
        for name, step in steps.items():
            results[f"{name}-p{mp}"] = _time_chained(step, q, k_pool, v_pool, chain, iters)
    return results


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="ftc-kernel-bench")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, nargs="*", default=[512, 1024, 2048, 4096])
    p.add_argument("--heads", type=int, default=32)
    p.add_argument("--kv-heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--device", default=None, help="cuda (default when present) or cpu")
    p.add_argument("--flash-variants", action="store_true",
                   help="sweep the packing (documents per row) of the flash path "
                        "instead of the impl comparison")
    p.add_argument("--paged-variants", action="store_true",
                   help="decode-step sweep of the paged-attention impls over pages-per-lane")
    p.add_argument("--page-tokens", type=int, default=16)
    p.add_argument("--pages-per-lane", type=int, nargs="*", default=[16, 64, 256])
    args = p.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    common = dict(heads=args.heads, kv_heads=args.kv_heads, head_dim=args.head_dim,
                  dtype=dtype, iters=args.iters, device=args.device)

    def ms(r: dict[str, float]) -> dict[str, float]:
        return {k: round(v * 1e3, 4) for k, v in r.items()}

    if args.paged_variants:
        r = ms(bench_paged_variants(batch=args.batch, page_tokens=args.page_tokens,
                                    pages_per_lane=tuple(args.pages_per_lane), **common))
        print(json.dumps({
            "shape": f"b{args.batch} h{args.heads}/{args.kv_heads} d{args.head_dim} "
                     f"t{args.page_tokens}",
            "unit": "ms/decode-step", **r,
        }))
        return
    for seq in args.seq:
        if args.flash_variants:
            r = ms(bench_flash_variants(batch=args.batch, seq=seq, **common))
            routes = [k for k in r if not k.startswith("sdpa")]  # sdpa: a yardstick
            extra = {"unit": "ms/call (grad)", "winner": min(routes, key=r.get)}
        else:
            r = ms(bench_attention(batch=args.batch, seq=seq, **common))
            grads = {k: v for k, v in r.items()
                     if k.endswith("_grad_s") and not k.startswith("sdpa")}
            extra = {"unit": "ms/call", "winner_grad": min(grads, key=grads.get)[:-7]}
        print(json.dumps({
            "shape": f"b{args.batch} s{seq} h{args.heads}/{args.kv_heads} d{args.head_dim}",
            **r, **extra,
        }))


if __name__ == "__main__":
    main()
