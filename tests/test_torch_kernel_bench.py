"""The port's kernel bench (``ops/kernel_bench.py``) and its ``auto`` gate.

The bench functions run here on the plain path at a tiny shape (the CUDA
kernels run only on the card: ``chip_smoke.py`` phase B times them there).
``preferred_impl`` keeps the kernel on CUDA at every length and the plain
version on the CPU, and the attention seams' ``auto`` follows it; the
chained timer feeds every output into the next call.  Nothing sleeps.
"""

from __future__ import annotations

import json

import pytest
import torch

from finetune_controller_tpu_torch.ops import attention, kernel_bench

TINY = dict(heads=4, kv_heads=2, head_dim=16, dtype=torch.float32, iters=2, device="cpu")


@pytest.mark.parametrize("seq", [1, 8, 512, 1023, 1024, 2048, 8192, 131072])
def test_preferred_impl_kernel_on_cuda_plain_on_cpu_at_every_length(seq):
    assert kernel_bench.preferred_impl(seq, "cuda") == "kernel"
    assert kernel_bench.preferred_impl(seq, torch.device("cuda", 0)) == "kernel"
    assert kernel_bench.preferred_impl(seq, "cpu") == "plain"


def test_auto_seams_follow_the_gate(monkeypatch):
    monkeypatch.delenv("FTC_FLASH_ATTN", raising=False)
    monkeypatch.delenv("FTC_PAGED_ATTN", raising=False)
    calls = []
    real = kernel_bench.preferred_impl

    def spy(seq_len, device=None):
        calls.append((seq_len, torch.device(device).type))
        return real(seq_len, device)

    monkeypatch.setattr(kernel_bench, "preferred_impl", spy)
    q = torch.zeros(1, 24, 4, 16)
    assert attention.flash_attention_impl(q) == "plain"
    assert attention.paged_attention_impl(q[:, :1]) == "gather"
    assert calls == [(24, "cpu"), (1, "cpu")]


def test_time_chained_feeds_each_output_into_the_next_call():
    seen = []

    def fn(q, k, v):
        seen.append(float(q[0]))
        return q + 1

    per_call = kernel_bench._time_chained(fn, torch.zeros(3), None, None,
                                          kernel_bench._chain_fwd, iters=3, warmup=2)
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert per_call > 0


def test_bench_attention_runs_the_plain_path():
    r = kernel_bench.bench_attention(batch=1, seq=32, **TINY)
    assert set(r) == {"plain_fwd_s", "plain_grad_s", "sdpa_fwd_s", "sdpa_grad_s"}
    assert all(v > 0 for v in r.values())


def test_bench_flash_variants_runs_the_plain_path():
    r = kernel_bench.bench_flash_variants(batch=1, seq=32, documents=(1, 4), **TINY)
    # sdpa (a yardstick) takes no segment ids, so it times the causal layout only
    assert set(r) == {"plain-docs1", "sdpa-docs1", "plain-docs4"}
    assert all(v > 0 for v in r.values())


def test_bench_paged_variants_runs_the_gather_path():
    r = kernel_bench.bench_paged_variants(batch=2, page_tokens=4, pages_per_lane=(2, 4),
                                          **TINY)
    assert set(r) == {"gather-p2", "sdpa-p2", "gather-p4", "sdpa-p4"}
    assert all(v > 0 for v in r.values())


def test_sdpa_yardstick_computes_the_same_function():
    """The yardstick is the same attention (so its time is comparable)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 20, h, 16, generator=g) for h in (4, 2, 2))
    torch.testing.assert_close(kernel_bench._sdpa(q, k, v),
                               attention.xla_causal_attention(q, k, v),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("argv,keys", [
    (["--seq", "16", "32"], {"plain_fwd_s", "plain_grad_s", "sdpa_fwd_s", "sdpa_grad_s",
                             "winner_grad"}),
    (["--seq", "16", "--flash-variants"], {"plain-docs1", "sdpa-docs1", "plain-docs4",
                                          "winner"}),
    (["--paged-variants", "--pages-per-lane", "2", "--page-tokens", "4"],
     {"gather-p2", "sdpa-p2"}),
])
def test_cli_prints_json(argv, keys, capsys):
    kernel_bench.main(["--batch", "1", "--heads", "4", "--kv-heads", "2", "--head-dim", "16",
                       "--iters", "1", "--dtype", "float32", "--device", "cpu", *argv])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines and all(keys <= set(line) for line in lines)
    for line in lines:
        assert line.get("winner_grad", "plain") == "plain"  # sdpa is never a route
        assert line.get("winner", "plain-docs1").startswith("plain")
