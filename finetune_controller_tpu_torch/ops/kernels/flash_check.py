"""Quick check of the bf16 flash kernels alone on one CUDA card.

    python -m finetune_controller_tpu_torch.ops.kernels.flash_check

Builds ``csrc/flash_attention.cu``, prints ptxas's register and spill line
of each kernel, holds the forward, dQ and dK/dV kernels against their plain
versions (bf16 at D 64, 128 and 256, and f32 at D 256; full, causal, causal
with segment ids and full with segment ids; S 128, 300 and 1024; and the
:func:`segment_layouts` at S 300), then times the forward, dQ and dK/dV
kernels at the training shapes (B=2, S=2048, H=32, Hkv=8, D=128) and at
Gemma-7B's heads (H=Hkv=16, D=256) on random documents of ~1500 tokens and
with no segment ids.  Exits non-zero without a card or on any mismatch.
``chip_smoke.py`` is the full check; this one skips serving and training,
for work on the kernels.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import build
from . import flash_attention as fa
from .timing import cuda_time_ms

#: max abs error allowed here (bf16 outputs of O(1) values; the card tests
#: hold every kernel to ``fa.TOLERANCE`` with its relative part)
LIMITS = {"out": 0.03, "lse": 0.03, "dq": 0.05, "dk": 0.05, "dv": 0.05}


def segment_layouts(b: int, s: int) -> dict[str, np.ndarray]:
    """(b, s) int32 segment ids that stress tile skipping, from a fixed seed:
    documents of 20-200 tokens as packing makes them; 16-token documents
    (most tile pairs dead); boundaries exactly on the 64- and 128-token tile
    edges; random ids in random runs (not monotone); packed documents
    followed by the loader's trailing padding id 0 over the last seventh."""
    rng = np.random.default_rng(0)
    pos = np.arange(s)

    def packed():
        return np.stack([np.cumsum(np.isin(pos, np.cumsum(rng.integers(20, 200, s)))) + 1
                         for _ in range(b)])

    padded = packed()
    padded[:, s - s // 7:] = 0
    layouts = {
        "packed": packed(),
        "short_docs": np.tile(pos // 16 + 1, (b, 1)),
        "tile_edge": np.tile(1 + (pos >= 64) + (pos >= 128) + (pos >= 256), (b, 1)),
        "nonmonotonic": np.stack([np.repeat(rng.integers(0, 5, s), rng.integers(1, 40, s))[:s]
                                  for _ in range(b)]),
        "trailing_padding": padded,
    }
    return {name: ids.astype(np.int32) for name, ids in layouts.items()}


def _compare(gen, d, b, s, h, hkv, causal, seg, label, dtype=torch.bfloat16) -> bool:
    """Forward, dQ and dK/dV against their plain versions on one case;
    prints one line and returns whether every error is inside ``LIMITS``."""

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, dout = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, h, d)
    out_ref, lse_ref = fa.flash_forward_reference(q, k, v, seg, None, causal)
    delta = fa.flash_delta(out_ref, dout)
    dq_ref, dk_ref, dv_ref = fa._backward_plain(q, k, v, dout, lse_ref, delta, seg, None, causal)
    out, lse = fa.flash_forward(q, k, v, seg, None, causal)
    dq = fa.flash_backward_dq(q, k, v, dout, lse_ref, delta, seg, None, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse_ref, delta, seg, None, causal)
    torch.cuda.synchronize()
    errs = {name: (got.float() - want.float()).abs().max().item()
            for name, got, want in (("out", out, out_ref), ("lse", lse, lse_ref),
                                    ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    ok = all(errs[name] <= LIMITS[name] for name in errs)
    print(f"D={d} {str(dtype)[6:]} (b, s, h, hkv)={(b, s, h, hkv)} {label}: "
          + " ".join(f"{name} {e:.4g}" for name, e in errs.items()) + ("" if ok else " BAD"),
          flush=True)
    return ok


def check(gen) -> bool:
    """Forward, dQ and dK/dV against their plain versions: full, causal, causal
    and full with 97-token documents at three shapes, then causal on each
    of :func:`segment_layouts` (inputs from a generator of their own)."""
    ok = True
    for d, dtype in ((64, torch.bfloat16), (128, torch.bfloat16), (256, torch.bfloat16),
                     (256, torch.float32)):
        for b, s, h, hkv in ((1, 128, 1, 1), (2, 300, 8, 2), (1, 1024, 4, 1)):
            for mode in ("full", "causal", "seg", "segfull"):
                seg = None
                if mode.startswith("seg"):
                    seg = (torch.arange(s, device="cuda") // 97 + 1).to(torch.int32)
                    seg = seg[None].repeat(b, 1)
                ok &= _compare(gen, d, b, s, h, hkv, mode in ("causal", "seg"), seg, mode,
                               dtype)
    layout_gen = torch.Generator(device="cuda").manual_seed(1)
    for d in (64, 128, 256):
        for name, ids in segment_layouts(2, 300).items():
            ok &= _compare(layout_gen, d, 2, 300, 8, 2, True, torch.from_numpy(ids).cuda(), name)
    return ok


def bench(gen) -> None:
    """Kernel times (ms) at the training shapes and at Gemma-7B's heads, with
    and without segment ids."""
    for shape in ((2, 2048, 32, 8, 128), (2, 2048, 16, 16, 256)):
        _bench_shape(gen, *shape)


def _bench_shape(gen, b, s, h, hkv, d) -> None:
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                     for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))
    starts = torch.rand((b, s), generator=gen, device="cuda") < 1.0 / 1500
    docs = (torch.cumsum(starts.int(), 1, dtype=torch.int32) + 1).contiguous()
    for label, seg in (("documents of ~1500 tokens", docs), ("no segment ids", None)):
        out, lse = fa.flash_forward_reference(q, k, v, seg, None, True)
        delta = fa.flash_delta(out, dout)
        times = {
            "forward": cuda_time_ms(lambda i: fa.flash_forward(q, k, v, seg, None, True), 20),
            "dq": cuda_time_ms(lambda i: fa.flash_backward_dq(q, k, v, dout, lse, delta, seg,
                                                              None, True), 20),
            "dkv": cuda_time_ms(lambda i: fa.flash_backward_dkv(q, k, v, dout, lse, delta, seg,
                                                                None, True), 20),
        }
        print(f"{(b, s, h, hkv, d)} {label}: "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_check: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    build.build(["flash_attention"])
    for fn, line in build.ptxas_report("flash_attention").items():
        print(f"  ptxas {fn}: {line}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = check(gen)
    bench(gen)
    print("flash_check: ok" if ok else "flash_check: MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
