#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one CUDA card.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port from ``finetune_controller_tpu_torch/
   csrc`` (one ``nvcc`` per source, in parallel) and check each kernel once
   against its plain version at a small shape, in f32 and bf16;
3. build ``llama3-8b`` at full width (and full depth unless ``--layers``
   cuts it) in bf16 with random weights drawn on the card from ``--seed``;
4. serve 12 requests through ``Batcher`` -> ``BatchEngine`` -> the paged
   kernel with the service defaults (8 slots, buckets 32/128/512, 128 new
   tokens at most, 16-token pages, auto-sized pool, prefix cache on): more
   requests than slots, prompts of 20-500 tokens, four sharing a 300-token
   prefix (a copy-on-write page), 10 greedy and 2 sampled.  Every kernel's
   launch count is zeroed just before this run and read just after;
5. check that all 12 finished with the lengths asked for, that no decode
   step failed, and that every kernel of the path was launched;
6. hold each kernel against its plain version on the card at the engine's
   shapes (decode B=8, S=1 over the pool and tables the run produced;
   prefill B=1, S=512), and time kernel, plain version and the library
   yardstick beside the kernel's bound;
7. compare first-token logits of the model's paged prefill under
   ``FTC_PAGED_ATTN=kernel`` and ``FTC_PAGED_ATTN=gather``;
8. print the decode rate and time to first token, the ``kernels`` line, the
   card line, and last ``{"ok": true, "device": {...}}``.

Needs one card; exits non-zero where ``torch.cuda.is_available()`` is false
or the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
#: first-token logits, kernel vs gather engine path: max |diff| over the
#: largest |logit| (bf16 activations through every layer; see PERF.md)
LOGITS_REL_TOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` over ``reps`` calls, CUDA events."""
    import torch

    for i in range(3):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_requests(seed: int, vocab: int):
    """12 requests: 8 unrelated prompts of 20-500 tokens and 4 sharing a
    300-token prefix; max_new_tokens 16-128; the last two sampled."""
    from finetune_controller_tpu_torch.serve.engine import GenRequest

    rng = np.random.default_rng(seed)
    lens = [20, 47, 96, 130, 185, 260, 377, 500]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    shared = rng.integers(0, vocab, 300).tolist()
    prompts += [shared + rng.integers(0, vocab, n).tolist() for n in (9, 44, 121, 199)]
    new = [16, 128, 40, 96, 64, 24, 128, 32, 80, 48, 128, 56]
    reqs = []
    for i, (p, n) in enumerate(zip(prompts, new)):
        sampled = i >= 10
        reqs.append(GenRequest(
            request_id=f"req{i:02d}", tokens=p, max_new_tokens=n,
            temperature=0.8 if sampled else 0.0, top_k=50 if sampled else 0,
            seed=seed + i,
        ))
    return reqs


def kernel_check_small() -> float:
    """First launch: each dtype at a small shape against the plain version."""
    import torch
    from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
        TOLERANCE, paged_attention, paged_attention_reference,
    )

    worst = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, hkv, d, t, mp, p in ((3, 1, 8, 2, 128, 16, 5, 9),
                                           (1, 37, 4, 2, 64, 16, 4, 6),
                                           (2, 5, 8, 1, 256, 7, 6, 12)):
            q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((p, t, hkv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((p, t, hkv, d), generator=gen, device="cuda").to(dtype)
            table = torch.randint(0, p, (b, mp), generator=gen, device="cuda", dtype=torch.int32)
            table[:, -1] = 0
            idx = torch.randint(0, mp * t - s + 1, (b,), generator=gen, device="cuda",
                                dtype=torch.int32)
            got = paged_attention(q, k, v, table, idx)
            want = paged_attention_reference(q, k, v, table, idx)
            torch.cuda.synchronize()
            atol, rtol = TOLERANCE[dtype]
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err) if dtype == torch.bfloat16 else worst
            if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
                raise AssertionError(
                    f"kernel vs plain at {(b, s, h, hkv, d, t, mp)} {dtype}: max err {err}")
    return worst


def serve(engine, reqs):
    """Submit every request through the Batcher at once; returns results,
    the batcher, per-step (seconds, active lanes) and TTFTs (seconds)."""
    from finetune_controller_tpu_torch.serve.batcher import Batcher

    steps: list[tuple[float, int]] = []
    snapshots: list = []
    ttfts: list[float] = []
    orig_step = engine.step

    def timed_step():
        active = engine.active_requests
        if active:
            # the busiest step's tables/index feed the decode-shape check
            snapshots.append((int(engine._index.sum()), engine._tables.copy(),
                              engine._index.copy()))
        t0 = time.perf_counter()
        out = orig_step()  # ends in a device->host copy of the tokens
        steps.append((time.perf_counter() - t0, active))
        return out

    engine.step = timed_step

    async def go():
        batcher = Batcher(engine, max_queue=64, default_timeout_s=0,
                          ttft_observe=ttfts.append)
        try:
            results = await asyncio.gather(*(batcher.submit(r) for r in reqs))
        finally:
            await batcher.close()
        return results, batcher

    try:
        results, batcher = asyncio.run(go())
    finally:
        engine.step = orig_step
    busiest = max(snapshots, key=lambda s: s[0])
    return results, batcher, steps, ttfts, busiest


def attention_bench(kv, q, table, idx, reps):
    """Kernel / plain / library times (ms) cycling over every layer's pools,
    so the pools come from HBM as in the real step; max error vs plain."""
    import torch
    import torch.nn.functional as F
    from finetune_controller_tpu_torch.ops.attention import paged_gather
    from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
        TOLERANCE, paged_attention, paged_attention_reference,
    )

    n_layers = kv.k.shape[0]
    b, s, h, d = q.shape
    hkv = kv.k.shape[3]
    cap = table.shape[1] * kv.k.shape[2]
    qpos = idx.long()[:, None] + torch.arange(s, device=q.device)[None, :]
    mask = (torch.arange(cap, device=q.device)[None, None, :] <= qpos[:, :, None])[:, None]

    def library(i):
        k = paged_gather(kv.k[i % n_layers], table).transpose(1, 2)
        v = paged_gather(kv.v[i % n_layers], table).transpose(1, 2)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask)

    atol, rtol = TOLERANCE[q.dtype]
    worst = 0.0
    for layer in (0, n_layers - 1):
        got = paged_attention(q, kv.k[layer], kv.v[layer], table, idx).float()
        want = paged_attention_reference(q, kv.k[layer], kv.v[layer], table, idx).float()
        lib = library(layer).transpose(1, 2)
        if not torch.isfinite(got).all():
            raise AssertionError("kernel output is not finite")
        worst = max(worst, (got - want).abs().max().item())
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"kernel vs plain beyond (atol, rtol) = {(atol, rtol)}: "
                                 f"max abs err {worst}")
        lib_err = (lib.float() - want.float()).abs().max().item()
        if lib_err > 0.1:
            raise AssertionError(f"library yardstick disagrees with plain by {lib_err}")
    ms = cuda_time_ms(lambda i: paged_attention(q, kv.k[i % n_layers], kv.v[i % n_layers],
                                                table, idx), reps)
    plain_ms = cuda_time_ms(lambda i: paged_attention_reference(
        q, kv.k[i % n_layers], kv.v[i % n_layers], table, idx), reps)
    library_ms = cuda_time_ms(library, reps)
    # bound: each attended K/V row once, q and out once, table and index once
    rows = torch.clamp(idx.long() + s, max=cap).sum().item()
    item = kv.k.element_size()
    nbytes = (2 * rows * hkv * d * item + 2 * q.numel() * item
              + table.numel() * 4 + idx.numel() * 4)
    attended = sum(min(cap, int(i0) + j + 1) for i0 in idx.tolist() for j in range(s))
    flops = 4 * h * d * attended
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=worst,
                bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=int(nbytes), flops=int(flops))


def profile_decode(engine, reqs, steps: int = 4):
    """``torch.profiler`` over a few full-batch decode steps: wall time per
    step, device-busy share, and device time by kernel name.  The lanes are
    admitted (prefill) outside the window and evicted after it."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    for r in reqs[: engine.config.slots]:
        engine.admit(dataclasses.replace(r, request_id=f"prof-{r.request_id}",
                                         max_new_tokens=engine.config.max_new_tokens))
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        wall = time.perf_counter() - t0
    for r in reqs[: engine.config.slots]:
        engine.evict(f"prof-{r.request_id}")
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        # device-side events only: an operator's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
    device_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        step_ms=wall / steps * 1e3,
        device_ms_per_step=device_ms / steps if device_ms else None,
        device_busy=device_ms / (wall * 1e3) if device_ms else None,
        top=[(name[:60], us / 1e3 / steps) for name, us in top],
    )


def logits_check(model, prompts, pool_pages, page_tokens):
    """First-token logits of a paged prefill with the kernel and with the
    plain gather path, on a fresh pool each; returns the worst relative
    error (max |diff| / max |logit|)."""
    import torch
    from finetune_controller_tpu_torch.models.llama import PagedKV

    worst = 0.0
    mp = pool_pages - 1
    table = torch.arange(1, pool_pages, dtype=torch.int32, device="cuda")[None, :]
    for prompt in prompts:
        bucket = 512
        tokens = torch.zeros((1, bucket), dtype=torch.long, device="cuda")
        tokens[0, :len(prompt)] = torch.tensor(prompt, device="cuda")
        positions = torch.arange(bucket, dtype=torch.int32, device="cuda")[None, :]
        idx = torch.zeros((1,), dtype=torch.int32, device="cuda")
        out = {}
        for impl in ("kernel", "gather"):
            os.environ["FTC_PAGED_ATTN"] = impl
            kv = PagedKV.zeros(model.cfg, pool_pages, page_tokens, "cuda")
            out[impl] = model.forward_paged(tokens, positions, kv, table[:, :mp], idx,
                                            last_idx=len(prompt) - 1).float()
        os.environ.pop("FTC_PAGED_ATTN")
        if not torch.isfinite(out["kernel"]).all():
            raise AssertionError("kernel-path logits are not finite")
        rel = ((out["kernel"] - out["gather"]).abs().max()
               / out["gather"].abs().max()).item()
        worst = max(worst, rel)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0, help="cut depth (0 = the preset's)")
    ap.add_argument("--reps", type=int, default=64, help="timed launches per shape")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        from finetune_controller_tpu_torch.models.llama import (
            PRESETS, LlamaForCausalLM, init_random_,
        )
        from finetune_controller_tpu_torch.ops.kernels import build
        from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
            TOLERANCE, paged_attention,
        )
        from finetune_controller_tpu_torch.serve.engine import (
            BatchEngine, EngineConfig, warm_engine,
        )
    except ImportError as e:
        return fail(f"the port's package is not importable beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build every kernel source and check each once at a small shape
    t0 = time.perf_counter()
    try:
        built = build.build()
    except RuntimeError as e:
        return fail(f"kernel build: {e}")
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name in built:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    try:
        small_err = kernel_check_small()
    except (AssertionError, RuntimeError, ValueError) as e:
        return fail(f"small-shape kernel check: {e}")
    log(f"small-shape kernel check ok (bf16 max abs err {small_err:.4g})")

    # 3. the model
    cfg = PRESETS["llama3-8b"].replace(param_dtype=torch.bfloat16)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    t0 = time.perf_counter()
    model = init_random_(LlamaForCausalLM(cfg, device="cuda"), args.seed).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"llama3-8b: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")

    # 4. serve through the batcher
    ecfg = EngineConfig(slots=8, prompt_buckets=(32, 128, 512), max_new_tokens=128,
                        prefix_cache_bytes=512 << 20, page_tokens=16)
    engine = BatchEngine(model, ecfg)
    log(f"engine: pool {ecfg.effective_pool_pages} pages x {engine.kv.page_bytes} B, "
        f"{ecfg.pages_per_lane} pages per lane")
    t0 = time.perf_counter()
    warm_engine(engine)
    torch.cuda.synchronize()
    log(f"warm-up {time.perf_counter() - t0:.1f} s")
    reqs = make_requests(args.seed, cfg.vocab_size)
    paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results, batcher, steps, ttfts, busiest = serve(engine, reqs)
    except Exception as e:  # any request failure fails the phase
        return fail(f"serving: {type(e).__name__}: {e}")
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # 5. what came out
    stats = batcher.stats()
    if len(results) != len(reqs):
        return fail(f"{len(results)} of {len(reqs)} requests finished")
    for req, res in zip(reqs, results):
        if res.request_id != req.request_id or len(res.generated) != req.max_new_tokens \
                or res.finish_reason != "length" \
                or not all(0 <= t < cfg.vocab_size for t in res.generated):
            return fail(f"bad result for {req.request_id}: {res.finish_reason}, "
                        f"{len(res.generated)} of {req.max_new_tokens} tokens")
    if stats["step_errors_total"] != 0:
        return fail(f"step_errors_total = {stats['step_errors_total']}")
    if launches <= 0:
        return fail("the paged-attention kernel was not launched on the main path")
    if engine.prefix_hits_total < 3 or stats["kv_cow_copies_total"] < 1:
        return fail(f"expected prefix hits and a copy-on-write page, got "
                    f"{engine.prefix_hits_total} hits, {stats['kv_cow_copies_total']} copies")
    decode_time = sum(dt for dt, _ in steps)
    decode_tokens = sum(active for _, active in steps)
    ttfts_ms = sorted(t * 1e3 for t in ttfts)
    log(f"served {len(results)} requests in {wall:.2f} s: {stats['tokens_generated_total']} "
        f"tokens, {len(steps)} decode steps, {launches} kernel launches, "
        f"{engine.prefix_hits_total} prefix hits, {stats['kv_cow_copies_total']} CoW copies, "
        f"peak memory {peak_gb:.2f} GB")
    log(f"decode: {decode_tokens / decode_time:.1f} tokens/s over {len(steps)} steps "
        f"({decode_time / len(steps) * 1e3:.2f} ms/step mean, up to 8 lanes)")
    log(f"time to first token (queue + prefill): p50 {ttfts_ms[len(ttfts_ms) // 2]:.1f} ms, "
        f"max {ttfts_ms[-1]:.1f} ms over {len(ttfts_ms)} requests")

    # 6. kernel vs plain at the engine's shapes, and times
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    _, tables, index = busiest
    shapes = {}
    try:
        q = torch.randn((8, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        shapes["decode"] = attention_bench(
            engine.kv, q, torch.from_numpy(tables).cuda(), torch.from_numpy(index).cuda(),
            args.reps)
        perm = torch.randperm(ecfg.effective_pool_pages - 1, generator=gen, device="cuda") + 1
        table = perm[: ecfg.pages_per_lane].to(torch.int32)[None, :]
        q = torch.randn((1, 512, cfg.n_heads, cfg.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        shapes["prefill"] = attention_bench(
            engine.kv, q, table, torch.zeros((1,), dtype=torch.int32, device="cuda"),
            max(8, args.reps // 4))
    except (AssertionError, RuntimeError, ValueError) as e:
        return fail(f"kernel at engine shapes: {e}")
    for name, r in shapes.items():
        log(f"paged_attention {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bytes']} B, {r['flops']} FLOP), "
            f"max abs err {r['max_abs_err']:.4g} (tolerance {TOLERANCE[torch.bfloat16]})")

    # 7. engine path: kernel vs gather first-token logits
    prompts = [reqs[i].tokens for i in (0, 5, 7)]
    try:
        rel = logits_check(model, prompts, ecfg.pages_per_lane + 1, ecfg.page_tokens)
    except (AssertionError, RuntimeError, ValueError) as e:
        return fail(f"logits check: {e}")
    log(f"first-token logits, kernel vs gather: max |diff| / max |logit| = {rel:.4g} "
        f"(tolerance {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        return fail("first-token logits differ beyond the tolerance")

    # where a decode step's time goes (not part of the main path's counts)
    prof = profile_decode(engine, reqs)
    if prof["device_busy"] is None:
        log("decode profile: the profiler recorded no device time (not measured)")
    else:
        log(f"decode profile (8 lanes): {prof['step_ms']:.2f} ms/step wall, "
            f"{prof['device_ms_per_step']:.2f} ms/step device, "
            f"device busy {prof['device_busy']:.3f}")
        for name, ms in prof["top"]:
            log(f"  {ms:8.3f} ms/step  {name}")

    # 8. the record
    dec = shapes["decode"]
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "finetune_controller_tpu_torch/csrc/paged_attention.cu",
        "replaces": "finetune_controller_tpu/ops/pallas/paged_attention.py:65",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"], "library_ms": dec["library_ms"],
        "shapes": {name: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "max_abs_err")}
                   for name, r in shapes.items()},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"serve": {
        "requests": len(results), "tokens": stats["tokens_generated_total"],
        "decode_tokens_per_s": decode_tokens / decode_time,
        "decode_ms_per_step": decode_time / len(steps) * 1e3,
        "ttft_ms_p50": ttfts_ms[len(ttfts_ms) // 2], "ttft_ms_max": ttfts_ms[-1],
        "wall_s": wall, "peak_memory_gb": peak_gb, "layers": cfg.n_layers,
        "logits_rel_err": rel, "profile": prof,
    }}), flush=True)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
