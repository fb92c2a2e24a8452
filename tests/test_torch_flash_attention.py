"""Flash attention in the PyTorch port against the JAX reference.

The same numpy inputs go through the JAX ``flash_attention_with_lse`` (the
Pallas kernels in interpret mode, blocks of 16, as ``tests/test_scaleout.py``
runs them) and the port's ``FlashAttention`` on the CPU, which runs the
kernels' plain versions.  out, lse and the gradients dq, dk, dv of a loss
that weighs both outputs (so the lse cotangent is non-zero) are compared in
f32: atol 1e-5 for the outputs, 1e-4 for the gradients (summation order
only).

``live_tiles`` (the tile-skipping predicate of the Hopper kernels) is
checked on the CPU: every live (query, key) pair lies in a live tile pair,
on packed, non-monotonic and trailing-padding segment ids at a ragged S.

The CUDA kernels are held against the plain versions on the card (head
dims 64, 128 and Gemma's 256), also on those segment layouts, and the
Hopper kernels (forward, dQ, dK/dV) are checked to be bitwise
deterministic; those tests carry the ``cuda`` marker and skip without one.
``ring`` and ``ulysses`` on one device run plain attention, as the
reference's do without an ``sp`` axis, and every card example on the
kernel path has a head dim the kernels take.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from finetune_controller_tpu_torch.ops.attention import (
    causal_attention,
    flash_attention_impl,
    xla_causal_attention,
)
from finetune_controller_tpu_torch.ops.kernels import flash_attention as fa
from finetune_controller_tpu_torch.ops.kernels import flash_check

torch.set_num_threads(1)

# (b, s, h, hkv, causal, segments): GQA group 1 and 2, packing segments, a
# ragged S, and full attention whose key segments differ from the query
# segments so some rows have no live key at all
CASES = {
    "group1": (2, 32, 2, 2, True, None),
    "group2_segments": (2, 32, 4, 2, True, "same"),
    "ragged_s40": (2, 40, 4, 2, True, "same"),
    "full_masked_rows": (2, 40, 4, 2, False, "distinct"),
}
D = 16

# segment layouts of the tile-skipping checks, (B, S) at a ragged S
LAYOUT_S = 300
LAYOUTS = flash_check.segment_layouts(2, LAYOUT_S)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from finetune_controller_tpu.ops.pallas.flash_attention import flash_attention_with_lse

    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=flash_attention_with_lse)


def _inputs(name):
    b, s, h, hkv, causal, segments = CASES[name]
    rng = np.random.default_rng(len(name))
    arrays = dict(
        q=rng.standard_normal((b, s, h, D), np.float32),
        k=rng.standard_normal((b, s, hkv, D), np.float32),
        v=rng.standard_normal((b, s, hkv, D), np.float32),
        g_out=rng.standard_normal((b, s, h, D), np.float32),
        g_lse=rng.standard_normal((b, h, s, 1), np.float32),
    )
    seg = kvseg = None
    if segments:
        seg = (np.arange(s)[None, :] // 13).repeat(b, 0).astype(np.int32)
        seg[1] = np.arange(s) // 7
    if segments == "distinct":  # queries of the last segments match no key
        kvseg = np.where(np.arange(s)[None, :] >= 20, seg + 10, seg).astype(np.int32)
    return arrays, seg, kvseg, causal


def _jax_run(ref, arrays, seg, kvseg, causal):
    jnp = ref.jnp

    def loss(q, k, v):
        out, lse = ref.flash(
            q, k, v, causal=causal, block_q=16, block_k=16, interpret=True,
            segment_ids=None if seg is None else jnp.asarray(seg),
            kv_segment_ids=None if kvseg is None else jnp.asarray(kvseg))
        return (out * arrays["g_out"]).sum() + (lse * arrays["g_lse"]).sum(), (out, lse)

    (_, (out, lse)), grads = ref.jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(arrays[n]) for n in ("q", "k", "v")))
    return [np.asarray(x) for x in (out, lse, *grads)]


def _port_run(arrays, seg, kvseg, causal):
    q, k, v = (torch.tensor(arrays[n], requires_grad=True) for n in ("q", "k", "v"))
    out, lse = fa.flash_attention_with_lse(
        q, k, v, causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        kv_segment_ids=None if kvseg is None else torch.from_numpy(kvseg))
    loss = (out * torch.from_numpy(arrays["g_out"])).sum() + (
        lse * torch.from_numpy(arrays["g_lse"])).sum()
    loss.backward()
    return [x.detach().numpy() for x in (out, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_jax(ref, name):
    arrays, seg, kvseg, causal = _inputs(name)
    want = _jax_run(ref, arrays, seg, kvseg, causal)
    got = _port_run(arrays, seg, kvseg, causal)
    for label, g, w, atol in zip(("out", "lse", "dq", "dk", "dv"), got, want,
                                 (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, atol=atol, rtol=atol, err_msg=label)
    if name == "full_masked_rows":  # rows with no live key: out 0, dq 0
        out, dq = got[0], got[2]
        dead = np.stack([~np.isin(seg[i], kvseg[i]) for i in range(len(seg))])
        assert dead.any()
        assert not out[dead].any() and not dq[dead].any()


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors each kernel wrapper returns exactly its plain version
    and counts no launch."""
    arrays, seg, kvseg, causal = _inputs("ragged_s40")
    q, k, v, dout = (torch.from_numpy(arrays[n]) for n in ("q", "k", "v", "g_out"))
    seg = torch.from_numpy(seg)
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
              fa.flash_backward_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, seg)
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, seg)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = fa.flash_delta(out, dout)
    dq, dk, dv = fa.flash_backward_reference(q, k, v, out, lse, dout, None, seg)
    assert torch.equal(fa.flash_backward_dq(q, k, v, dout, lse, delta, seg), dq)
    got_dk, got_dv = fa.flash_backward_dkv(q, k, v, dout, lse, delta, seg)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    assert before == (fa.flash_forward.launches, fa.flash_backward_dq.launches,
                      fa.flash_backward_dkv.launches)


@pytest.mark.parametrize("segments", [False, True])
def test_flash_path_matches_plain_attention(segments, monkeypatch):
    """``causal_attention`` with impl pallas/auto equals the xla path in f32."""
    monkeypatch.delenv("FTC_FLASH_ATTN", raising=False)
    arrays, seg, _, _ = _inputs("group2_segments")
    q, k, v = (torch.from_numpy(arrays[n]) for n in ("q", "k", "v"))
    seg = torch.from_numpy(seg) if segments else None
    want = xla_causal_attention(q, k, v, segment_ids=seg)
    for impl in ("pallas", "auto"):
        got = causal_attention(q, k, v, impl=impl, segment_ids=seg)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("raw,want", [(None, "plain"), ("auto", "plain"), ("plain", "plain"),
                                      (" Plain ", "plain")])
def test_dispatch_on_cpu(raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv("FTC_FLASH_ATTN", raising=False)
    else:
        monkeypatch.setenv("FTC_FLASH_ATTN", raw)
    assert flash_attention_impl(torch.zeros(1, 1, 2, D)) == want


def test_dispatch_refusals(monkeypatch):
    q = torch.zeros(1, 4, 2, D)
    monkeypatch.setenv("FTC_FLASH_ATTN", "kernel")
    with pytest.raises(ValueError, match="needs CUDA"):
        causal_attention(q, q, q, impl="pallas")
    monkeypatch.setenv("FTC_FLASH_ATTN", "turbo")
    with pytest.raises(ValueError, match="FTC_FLASH_ATTN"):
        flash_attention_impl(q)
    with pytest.raises(ValueError, match="unknown attention impl"):
        causal_attention(q, q, q, impl="nope")


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_ring_and_ulysses_on_one_device_match_the_reference(impl, segments):
    """With no ``sp`` axis the reference's ``causal_attention`` runs plain
    attention for both impls (``ops/attention.py:322-327``); so does the
    port's.  f32, atol 1e-5."""
    jnp = pytest.importorskip("jax.numpy")
    from finetune_controller_tpu.ops.attention import causal_attention as jax_causal_attention

    arrays, seg, _, _ = _inputs("group2_segments")
    seg = seg if segments else None
    want = jax_causal_attention(*(jnp.asarray(arrays[n]) for n in ("q", "k", "v")), impl=impl,
                                segment_ids=None if seg is None else jnp.asarray(seg))
    got = causal_attention(*(torch.from_numpy(arrays[n]) for n in ("q", "k", "v")), impl=impl,
                           segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_every_card_job_on_the_kernel_path_has_a_kernel_head_dim():
    """Each shipped example whose default device is the card and whose
    preset takes the flash path (``auto`` or ``pallas``) has a head dim the
    kernels take (Gemma's 256 among them)."""
    from finetune_controller_tpu_torch.controller.examples import BUILTIN_JOB_SPECS
    from finetune_controller_tpu_torch.models.llama import PRESETS
    from finetune_controller_tpu_torch.models.multimodal import MM_PRESETS

    seen = set()
    for spec in BUILTIN_JOB_SPECS:
        preset = spec.model_preset
        cfg = PRESETS[preset] if preset in PRESETS else MM_PRESETS[preset].text
        if spec.default_device != "h100" or cfg.attention_impl not in ("auto", "pallas"):
            continue
        assert cfg.head_dim in fa._HEAD_DIMS, (spec.model_name, cfg.head_dim)
        seen.add(cfg.head_dim)
    assert {128, 256} <= seen


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (64, 128),
                                   fa.TILES[128]["flash_backward_dq"],
                                   fa.TILES[256]["flash_forward"]])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_live_tiles_cover_live_pairs(name, tiles, causal):
    """Every live (query, key) pair of ``_live`` lies in a tile pair that
    ``live_tiles`` keeps, at a ragged S; where ids run up by one per
    document (all but the non-monotonic and padded layouts) it keeps no
    tile pair without one."""
    tq, tk = tiles
    seg = torch.from_numpy(LAYOUTS[name])
    b, s = seg.shape
    live = fa._live(s, seg.device, seg, seg, causal)[:, 0, 0]           # (B, S, S)
    tiles_live = fa.live_tiles(seg, None, tq, tk, causal)
    assert tiles_live.shape == (b, -(-s // tq), -(-s // tk))
    covered = tiles_live.repeat_interleave(tq, 1)[:, :s].repeat_interleave(tk, 2)[:, :, :s]
    assert not (live & ~covered).any()
    if name in ("packed", "short_docs", "tile_edge"):
        held = torch.nn.functional.pad(live.float(), (0, -s % tk, 0, -s % tq))
        held = held.reshape(b, -(-s // tq), tq, -(-s // tk), tk).amax((2, 4)) > 0
        assert torch.equal(held, tiles_live)


def test_live_tiles_skip_work_on_packed_batches():
    """On packed documents fewer tile pairs are live than causal ones, at
    every kernel's tile sizes; one document keeps every causal pair."""
    seg = torch.from_numpy(LAYOUTS["packed"])
    for name, (tq, tk) in ((f"{name} D={d}", t) for d, by_name in fa.TILES.items()
                           for name, t in by_name.items()):
        causal_only = fa.live_tiles(torch.zeros_like(seg), None, tq, tk, True)
        packed = fa.live_tiles(seg, None, tq, tk, True)
        assert packed.sum() < causal_only.sum(), name
        assert not (packed & ~causal_only).any()
    one_doc = fa.live_tiles(torch.ones_like(seg), None, 64, 64, True)
    assert torch.equal(one_doc, fa.live_tiles(torch.zeros_like(seg), None, 64, 64, True))
    with pytest.raises(ValueError, match="segment ids"):
        fa.live_tiles(None, None, 64, 64, True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(name):
    """(b, s, h, hkv, causal, seg, kvseg) of a card test case: CASES, or a
    segment layout at (2, LAYOUT_S, 8, 2), causal."""
    if name in CASES:
        b, s, h, hkv, causal, _ = CASES[name]
        _, seg, kvseg, _ = _inputs(name)
        return b, s, h, hkv, causal, seg, kvseg
    return 2, LAYOUT_S, 8, 2, True, LAYOUTS[name], None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("name", list(CASES) + list(LAYOUTS))
def test_kernels_match_plain_on_card(cuda, name, d, dtype):
    """Each CUDA kernel against its plain version, one launch each."""
    b, s, h, hkv, causal, seg, kvseg = _card_case(name)
    gen = torch.Generator(device=cuda).manual_seed(len(name) + d)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, k, v, dout = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, h, d)
    dlse = torch.randn((b, h, s), generator=gen, device=cuda)
    seg = None if seg is None else torch.from_numpy(seg).to(cuda)
    kvseg = None if kvseg is None else torch.from_numpy(kvseg).to(cuda)
    atol, rtol = fa.TOLERANCE[dtype]
    out_ref, lse_ref = fa.flash_forward_reference(q, k, v, seg, kvseg, causal)
    delta = fa.flash_delta(out_ref, dout, dlse)
    want = fa._backward_plain(q, k, v, dout, lse_ref, delta, seg, kvseg, causal)
    before = fa.flash_forward.launches
    out, lse = fa.flash_forward(q, k, v, seg, kvseg, causal)
    assert fa.flash_forward.launches == before + 1
    dq = fa.flash_backward_dq(q, k, v, dout, lse_ref, delta, seg, kvseg, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, dout, lse_ref, delta, seg, kvseg, causal)
    for got, ref_val in ((out, out_ref), (lse, lse_ref), (dq, want[0]), (dk, want[1]),
                         (dv, want[2])):
        torch.testing.assert_close(got.float(), ref_val.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_hopper_kernels_are_deterministic(cuda, d):
    """Two launches of the bf16 forward, dQ and dK/dV kernels give the same
    bits (no atomics: the GQA sum and every tile order are fixed)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    b, s, h, hkv = 2, 640, 8, 2
    q, k, v, dout = (torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
                     for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))
    seg = torch.from_numpy(flash_check.segment_layouts(b, s)["packed"]).to(cuda)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_forward(q, k, v, seg)
        delta = fa.flash_delta(out, dout)
        runs.append((out, lse, fa.flash_backward_dq(q, k, v, dout, lse, delta, seg),
                     *fa.flash_backward_dkv(q, k, v, dout, lse, delta, seg)))
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernel_path_raises_on_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(q, q, q)
