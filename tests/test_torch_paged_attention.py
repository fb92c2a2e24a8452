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

The kernel splits the key range across blocks and merges f32 partials
(flash-decoding).  :func:`paged_attention_split_reference`, a plain model
of that split and merge, is held against the plain path and the JAX oracle
on the CPU, with empty splits and splits past the causal frontier.

The CUDA kernel is held against the port's plain path on the card, also at
split edges, and two launches must give the same bits; those tests carry
the ``cuda`` marker and skip without one.  On a machine with a
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
from finetune_controller_tpu_torch.ops.kernels import paged_check
from finetune_controller_tpu_torch.ops.kernels.paged_attention import (
    TOLERANCE,
    paged_attention,
    paged_attention_reference,
    paged_splits,
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


def paged_attention_split_reference(q, k_pool, v_pool, page_table, idx, splits: int,
                                    align: int = 64) -> torch.Tensor:
    """A plain model of the kernel's split and merge: each lane's attended
    range [0, idx + S) is cut into ``splits`` parts of equal length rounded
    up to ``align`` positions (the kernel's chunk); each part gives an f32
    partial (max m, sum l, unnormalised p·V; an empty part has m = -inf and
    is skipped), and the partials merge as Σ e^(m−M)·acc / Σ e^(m−M)·l."""
    b, s, h, d = q.shape
    hkv = k_pool.shape[2]
    k = paged_gather(k_pool, page_table).float()
    v = paged_gather(v_pool, page_table).float()
    n = k.shape[1]
    idx = torch.as_tensor(idx).reshape(-1).expand(b).long()
    qs = (q * d ** -0.5).to(q.dtype).float().reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qs, k)
    pos = torch.arange(n)
    live = pos[None, None, :] <= (idx[:, None] + torch.arange(s)[None, :])[:, :, None]
    kmax = torch.clamp(idx + s, max=n)
    per = -(-(-(-kmax // splits)) // align) * align                 # (B,)
    part = pos[None, :] // per[:, None]                             # (B, N)
    ms, ls, accs = [], [], []
    for sp in range(splits):
        mask = (live & (part == sp)[:, None, :])[:, None, None]      # (B, 1, 1, S, N)
        sc = scores.masked_fill(~mask, float("-inf"))
        m = sc.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - torch.where(m.isfinite(), m, 0.0)), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgst,btkd->bkgsd", p, v))
    top = torch.stack(ms).amax(0)
    w = [torch.where(m.isfinite(), torch.exp(m - top), 0.0) for m in ms]
    out = sum(wi * a for wi, a in zip(w, accs)) / sum(wi * li for wi, li in zip(w, ls))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(v_pool.dtype)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_model_matches_plain_path_and_jax(ref, case, dtype, splits):
    """Split and merge change nothing beyond rounding: the model against the
    port's plain path and the JAX gather oracle.  With 7 splits of these
    short lanes most parts are empty or lie past the frontier; with 2 or 3
    at 16-position alignment parts end mid-lane."""
    arrays = _case(case, **CASES[case])
    got = paged_attention_split_reference(*_to_torch(arrays, _TORCH[dtype]), splits, align=16)
    plain = paged_attention_reference(*_to_torch(arrays, _TORCH[dtype]))
    want = ref.gather_oracle(*_to_jax(ref, arrays, ref.dtypes[dtype]))
    atol, rtol = TOLERANCE[_TORCH[dtype]]
    np.testing.assert_allclose(_np(got), _np(plain), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def test_split_model_empty_parts_add_nothing():
    """Lanes far shorter than a part, and parts wholly past idx + S − 1:
    the merge is exactly the one-part result in f32, and never NaN."""
    arrays = _case(11, b=4, s=1, mp=16, t=4, h=4, hkv=2, pool_pages=20)
    q, k, v, table, _ = _to_torch(arrays, torch.float32)
    idx = torch.tensor([0, 1, 5, 63], dtype=torch.int32)
    one = paged_attention_split_reference(q, k, v, table, idx, 1)
    for splits in (2, 5, 16):
        got = paged_attention_split_reference(q, k, v, table, idx, splits, align=4)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, one, atol=1e-5, rtol=1e-5)


def test_split_counts():
    """The split count at the engine's shapes (llama3-8b: 32 heads over 8 KV
    heads, 16-token pages, 40-page lanes): decode of 8 lanes splits 5 ways
    (320 blocks for 132 SMs), bf16 prefill never splits, and a short table
    or a wide batch gives fewer splits."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert paged_splits(8, 1, 32, 8, 640, bf16) == 5
    assert paged_splits(1, 512, 32, 8, 640, bf16) == 1
    assert paged_splits(1, 128, 32, 8, 640, bf16) == 1
    assert paged_splits(1, 1, 32, 8, 640, bf16) == 10      # 640 positions / 64
    assert paged_splits(8, 1, 32, 8, 64, bf16) == 1         # one part of 64 positions
    assert paged_splits(64, 1, 32, 8, 640, bf16) == 1       # 512 blocks already
    assert paged_splits(1, 1, 32, 8, 1 << 20, bf16) == 32   # the cap
    assert paged_splits(2, 5, 8, 1, 42, f32) == 1
    assert paged_splits(2, 32, 8, 1, 640, f32) == 9         # 32 blocks of 16 rows


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", range(len(paged_check.EDGE_CASES)))
def test_kernel_split_edges_on_card(cuda, case, d, dtype):
    """The kernel at the split edges of ``paged_check.EDGE_CASES``, with
    each split count of ``EDGE_SPLITS``, against the plain path; a second
    launch gives the same bits."""
    _, b, s, h, hkv, t, mp, lanes = paged_check.EDGE_CASES[case]
    rng = np.random.default_rng(case)
    pool_pages = b * mp + 1
    q = torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((pool_pages, t, hkv, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((pool_pages, t, hkv, d), np.float32))
    table = torch.from_numpy(
        (rng.permutation(pool_pages - 1)[: b * mp] + 1).reshape(b, mp).astype(np.int32))
    q, k, v, table = (x.to(cuda) for x in (q, k, v, table))
    q, k, v = (x.to(_TORCH[dtype]) for x in (q, k, v))
    idx = torch.tensor(lanes, dtype=torch.int32, device=cuda)
    want = paged_attention_reference(q, k, v, table, idx)
    atol, rtol = TOLERANCE[_TORCH[dtype]]
    for splits in paged_check.EDGE_SPLITS:
        got = paged_attention(q, k, v, table, idx, splits=splits)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        assert torch.equal(got, paged_attention(q, k, v, table, idx, splits=splits))
