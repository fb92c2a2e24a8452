"""Paged attention in the PyTorch port against the JAX reference.

The port's plain path (gather + ``chunked_cache_attention``) is held against
the JAX gather oracle and the Pallas kernel in interpret mode, on the same
inputs made with numpy from a seed, over the five cases of
``tests/test_paged_attention.py``.

Tolerances: f32 differs only by summation order (1e-6).  bf16 differs by
where the two frameworks round: JAX multiplies q by D^-0.5 rounded to bf16
(a weakly typed scalar), PyTorch by the f32 scale, and the score einsum's
bf16 result can land one ulp apart — so outputs of magnitude ~1 may differ
by a few bf16 ulps (2^-8 relative each): atol = rtol = 2e-2.

The CUDA kernel is held against the port's plain path on the card; that
test carries the ``cuda`` marker and skips without one.  On a machine with a
card run ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -m cuda``
(the f32 tolerances assume JAX on the CPU: JAX's default f32 matmul on a GPU
uses TF32).  The JAX reference is imported inside a fixture, so the card
test also runs where JAX is not installed (with ``--noconftest``).
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from finetune_controller_tpu_torch.ops.attention import (
    paged_attention_impl,
    paged_cache_attention,
    paged_gather,
)
from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
    TOLERANCE,
    paged_attention,
    paged_attention_reference,
)

torch.set_num_threads(1)

CASES = [
    dict(b=1, s=1, mp=2, t=4, h=4, hkv=2, pool_pages=5),    # decode step
    dict(b=3, s=1, mp=4, t=8, h=4, hkv=2, pool_pages=9),    # batched decode
    dict(b=2, s=8, mp=3, t=8, h=4, hkv=4, pool_pages=7),    # suffix prefill
    dict(b=2, s=4, mp=5, t=4, h=8, hkv=2, pool_pages=11),   # g=4 grouping
    dict(b=4, s=2, mp=2, t=16, h=2, hkv=1, pool_pages=3),   # MQA
]
TOL = {"float32": (1e-6, 1e-6), "bfloat16": (2e-2, 2e-2)}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference, imported here rather than at module level so that
    the card test below also runs where JAX is not installed."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from finetune_controller_tpu.ops.attention import chunked_cache_attention, paged_gather
    from finetune_controller_tpu.ops.pallas.paged_attention import paged_attention

    @jax.jit
    def gather_oracle(q, k_pool, v_pool, table, idx):
        return chunked_cache_attention(q, paged_gather(k_pool, table),
                                       paged_gather(v_pool, table), idx)

    return types.SimpleNamespace(
        jnp=jnp, gather_oracle=gather_oracle, pallas=paged_attention,
        paged_gather=paged_gather,
        dtypes={"float32": jnp.float32, "bfloat16": jnp.bfloat16},
    )


def _case(seed, *, b, s, mp, t, h, hkv, pool_pages, d=16):
    """numpy inputs: random pools (scratch page 0 holds values like a real
    pool), a random table whose last slot is the scratch page, per-row
    positions that straddle page boundaries."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((pool_pages, t, hkv, d), np.float32)
    v = rng.standard_normal((pool_pages, t, hkv, d), np.float32)
    table = rng.integers(0, pool_pages, (b, mp)).astype(np.int32)
    table[:, -1] = 0
    idx = rng.integers(0, mp * t - s + 1, (b,)).astype(np.int32)
    return q, k, v, table, idx


def _to_torch(arrays, dtype):
    q, k, v, table, idx = arrays
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(table), torch.from_numpy(idx))


def _to_jax(ref, arrays, dtype):
    q, k, v, table, idx = arrays
    jnp = ref.jnp
    return (jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            jnp.asarray(table), jnp.asarray(idx))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_path_matches_jax(ref, case, dtype, monkeypatch):
    """The port's plain path against the JAX gather oracle and the Pallas
    kernel in interpret mode (which the reference holds bit-identical to
    that oracle)."""
    monkeypatch.setenv("FTC_PAGED_ATTN", "gather")
    arrays = _case(case, **CASES[case])
    want = ref.gather_oracle(*_to_jax(ref, arrays, ref.dtypes[dtype]))
    pallas = ref.pallas(*_to_jax(ref, arrays, ref.dtypes[dtype]), interpret=True)
    got = paged_cache_attention(*_to_torch(arrays, _TORCH[dtype]))
    assert got.dtype == _TORCH[dtype]
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=atol, rtol=rtol)
    # on a CPU tensor the kernel wrapper runs exactly the plain version
    wrapped = paged_attention(*_to_torch(arrays, _TORCH[dtype]))
    assert torch.equal(wrapped, got)


def test_paged_gather_is_bit_identical_to_jax(ref):
    q, k, _, table, _ = _case(3, **CASES[3])
    got = paged_gather(torch.from_numpy(k), torch.from_numpy(table))
    want = ref.paged_gather(ref.jnp.asarray(k), ref.jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scalar_idx_matches_per_row():
    arrays = _case(7, b=3, s=1, mp=3, t=4, h=4, hkv=2, pool_pages=6)
    q, k, v, table, _ = _to_torch(arrays, torch.float32)
    got_scalar = paged_attention(q, k, v, table, 5)
    got_vec = paged_attention(q, k, v, table, torch.full((3,), 5, dtype=torch.int32))
    assert torch.equal(got_scalar, got_vec)


def test_dtype_mismatch_raises():
    q, k, v, table, idx = _to_torch(_case(0, **CASES[0]), torch.float32)
    with pytest.raises(ValueError, match="dtypes must match"):
        paged_attention(q.to(torch.bfloat16), k, v, table, idx)


@pytest.mark.parametrize("raw,want", [(None, "gather"), ("auto", "gather"),
                                      ("gather", "gather"), (" Gather ", "gather")])
def test_dispatch_on_cpu(raw, want, monkeypatch):
    """On CPU tensors ``auto`` is the plain gather path."""
    if raw is None:
        monkeypatch.delenv("FTC_PAGED_ATTN", raising=False)
    else:
        monkeypatch.setenv("FTC_PAGED_ATTN", raw)
    assert paged_attention_impl(torch.zeros(1, 1, 4, 16)) == want


def test_dispatch_kernel_on_cpu_raises(monkeypatch):
    """An explicit ``kernel`` never quietly runs the plain path."""
    monkeypatch.setenv("FTC_PAGED_ATTN", "kernel")
    q, k, v, table, idx = _to_torch(_case(1, **CASES[1]), torch.float32)
    with pytest.raises(ValueError, match="needs CUDA"):
        paged_cache_attention(q, k, v, table, idx)


def test_dispatch_rejects_unknown_impl(monkeypatch):
    monkeypatch.setenv("FTC_PAGED_ATTN", "turbo")
    with pytest.raises(ValueError, match="FTC_PAGED_ATTN"):
        paged_attention_impl(torch.zeros(1, 1, 4, 16))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged-attention kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_matches_plain_on_card(cuda, d, dtype):
    """The CUDA kernel against the port's plain path, at each head dim."""
    for i, spec in enumerate(CASES):
        q, k, v, table, idx = (x.to(cuda) for x in _to_torch(_case(i, d=d, **spec), _TORCH[dtype]))
        before = paged_attention.launches
        got = paged_attention(q, k, v, table, idx)
        assert paged_attention.launches == before + 1
        want = paged_attention_reference(q, k, v, table, idx)
        atol, rtol = TOLERANCE[_TORCH[dtype]]
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
