"""Quick check of the paged-attention kernel alone on one CUDA card.

    python -m finetune_controller_tpu_torch.ops.kernels.paged_check

Builds ``csrc/paged_attention.cu``, prints ptxas's register and spill line
of each kernel, holds the kernel against its plain version (:func:`check`:
f32 and bf16, D 64/128/256, at random shapes and at the split edges of
:data:`EDGE_CASES`, each call launched twice for identical bits), then times
it at llama3-8b's serving shapes (:func:`bench`: 8 decode lanes of 150-610
positions, a 512-token prefill and a 128-token suffix prefill at idx 300,
over 8 layers' pools): the device time of a CUDA-graph replay, the time of
calls back to back (the wrapper's host work included), and the device time
of the attention and combine kernels apart, for several split counts of the
decode.  Exits non-zero without a card or on any mismatch.
``chip_smoke.py`` is the full check; this one skips serving and training,
for work on the kernel.
"""

from __future__ import annotations

import sys

import torch

from . import build
from . import paged_attention as pa
from .timing import cuda_time_ms, graph_time_ms

#: (label, b, s, h, hkv, t, mp, idx): decode lanes with idx on and beside
#: page (16) and chunk (32, 64) boundaries, lanes far shorter than one split
#: beside full ones, S·G at 16 rows (the largest decode tile) and at 20 (the
#: bf16 prefill design), and a prefill at idx > 0 with odd 7-token pages
EDGE_CASES = (
    ("page and chunk edges", 10, 1, 8, 2, 16, 8, (0, 3, 15, 16, 31, 32, 63, 64, 100, 127)),
    ("short and long lanes", 4, 1, 8, 2, 16, 40, (2, 17, 300, 639)),
    ("16 rows", 3, 4, 8, 2, 16, 8, (0, 29, 100)),
    ("20 rows", 3, 5, 8, 2, 16, 8, (0, 29, 100)),
    ("suffix prefill", 2, 65, 4, 2, 7, 30, (0, 140)),
)
#: split counts each edge case runs with (None: the default, paged_splits)
EDGE_SPLITS = (None, 1, 2, 3, 7)


def check(gen) -> float:
    """The kernel against its plain version: f32 and bf16 at three random
    shapes, then each of :data:`EDGE_CASES` at D 64/128/256 with each of
    :data:`EDGE_SPLITS`; a second launch must give the same bits.  Raises
    ``AssertionError`` on a mismatch; returns the worst bf16 error."""
    worst = 0.0

    def one(q, k, v, table, idx, label, splits=None):
        nonlocal worst
        got = pa.paged_attention(q, k, v, table, idx, splits=splits)
        again = pa.paged_attention(q, k, v, table, idx, splits=splits)
        want = pa.paged_attention_reference(q, k, v, table, idx)
        torch.cuda.synchronize()
        atol, rtol = pa.TOLERANCE[q.dtype]
        err = (got.float() - want.float()).abs().max().item()
        if q.dtype == torch.bfloat16:
            worst = max(worst, err)
        where = f"{label} D={q.shape[-1]} {q.dtype} splits={splits}"
        if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"paged kernel vs plain at {where}: max err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"paged kernel at {where}: two launches differ")

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, hkv, d, t, mp, p in ((3, 1, 8, 2, 128, 16, 5, 9),
                                           (1, 37, 4, 2, 64, 16, 4, 6),
                                           (2, 5, 8, 1, 256, 7, 6, 12)):
            q, k, v = (rnd(shape, dtype) for shape in ((b, s, h, d), (p, t, hkv, d),
                                                        (p, t, hkv, d)))
            table = torch.randint(0, p, (b, mp), generator=gen, device="cuda", dtype=torch.int32)
            table[:, -1] = 0
            idx = torch.randint(0, mp * t - s + 1, (b,), generator=gen, device="cuda",
                                dtype=torch.int32)
            one(q, k, v, table, idx, f"random {(b, s, h, hkv, t, mp)}")
        for label, b, s, h, hkv, t, mp, lanes in EDGE_CASES:
            for d in (64, 128, 256):
                p = b * mp + 1
                q, k, v = (rnd(shape, dtype) for shape in ((b, s, h, d), (p, t, hkv, d),
                                                            (p, t, hkv, d)))
                table = torch.randperm(p - 1, generator=gen, device="cuda")[: b * mp] + 1
                table = table.reshape(b, mp).to(torch.int32)
                idx = torch.tensor(lanes, dtype=torch.int32, device="cuda")
                for splits in EDGE_SPLITS:
                    one(q, k, v, table, idx, label, splits)
    return worst


def _kernel_us(fn, calls: int = 32) -> dict[str, float]:
    """Device µs per call of each kernel ``fn(i)`` launches, by
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            name = "combine" if "combine" in evt.key else "attention"
            us = getattr(evt, "self_device_time_total", None)
            us = getattr(evt, "self_cuda_time_total", 0.0) if us is None else us
            out[name] = out.get(name, 0.0) + us / calls
    return out


def bench(gen, reps: int = 64) -> None:
    """Times at llama3-8b's serving shapes (32 heads over 8 KV heads, D 128,
    bf16, 16-token pages, 40-page lanes), cycling over 8 layers' pools."""
    layers, pages, t, hkv, d, h = 8, 8 * 41 + 1, 16, 8, 128, 32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ks = [torch.randn((pages, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(layers)]
    vs = [torch.randn((pages, t, hkv, d), generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(layers)]
    shapes = (("decode", 8, 1, (150, 400, 520, 610, 330, 200, 470, 600), (None, 2, 3, 4, 8, 10)),
              ("prefill", 1, 512, (0,), (None,)), ("suffix prefill", 1, 128, (300,), (None,)))
    for label, b, s, lanes, split_counts in shapes:
        table = torch.randperm(pages - 1, generator=gen, device="cuda")[: b * 40] + 1
        table = table.reshape(b, 40).to(torch.int32)
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        idx = torch.tensor(lanes, dtype=torch.int32, device="cuda")
        for splits in split_counts:
            def call(i, splits=splits):
                return pa.paged_attention(q, ks[i % layers], vs[i % layers], table, idx,
                                          splits=splits)

            used = splits or pa.paged_splits(b, s, h, hkv, 40 * t, torch.bfloat16, sms)
            kernels = ", ".join(f"{k} {us:.2f} µs" for k, us in _kernel_us(call).items())
            print(f"{label} (B={b}, S={s}) {used} split(s): graph replay "
                  f"{graph_time_ms(call, reps) * 1e3:.2f} µs, back to back "
                  f"{cuda_time_ms(call, reps) * 1e3:.2f} µs; kernels {kernels}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_check: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    build.build(["paged_attention"])
    for fn, line in build.ptxas_report("paged_attention").items():
        print(f"  ptxas {fn}: {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    try:
        worst = check(gen)
    except AssertionError as e:
        print(f"paged_check: MISMATCH: {e}", flush=True)
        return 1
    print(f"paged_check: every case within TOLERANCE (bf16 max abs err {worst:.4g}), "
          "two launches identical", flush=True)
    bench(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
