"""The port's int4 QLoRA base (``models/quant.py``) against the reference's.

* ``quantize_int4`` / ``dequantize_int4``: bit-equal (packed bytes, scale
  bits, dequantized values in f32 and bf16) on random f32 matrices, an
  all-zero block, values at exact half-steps of the scale and a stacked
  ``(E, in, out)`` tensor;
* ``Int4Matmul``: forward and ``grad_x`` against ``jax.grad`` through the
  reference's ``dequantize_int4`` (f32, atol 1e-6); its graph saves no
  dequantized ``(in, out)`` float tensor;
* the whole ``tiny-test`` model with ``quantize_base=True`` (f32): logits
  within 1e-4, LoRA gradients within rel 1e-4 of the reference's;
* a QLoRA job through ``cli.run_job(..., "cpu")``; the serving loader
  rebuilds the same int4 base bit for bit, serves it unmerged, and a bf16
  base the loader draws equals the trainer's f32 draw rounded to bf16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models import quant as jax_quant
from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu_torch.models import quant
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
from finetune_controller_tpu_torch.models.lora import LoRAConfig, LoRADense

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """The raw bytes of a numpy/jax/torch array, for bit-equality."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _matrix(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if case == "stacked":
        return rng.standard_normal((3, 128, 40)).astype(np.float32)
    w = (rng.standard_normal((256, 96)) * 0.7).astype(np.float32)
    if case == "zero_block":
        w[64:128, :17] = 0.0
    if case == "half_steps":
        # a column whose block absmax is 7 (scale exactly 1): every value
        # sits on a half-step, where half-to-even rounding decides
        w[:64, 5] = np.resize(np.arange(-6.5, 7.0, 1.0), 64)
        w[0, 5] = 7.0
    return w


@pytest.mark.parametrize("case", ["random", "zero_block", "half_steps", "stacked"])
def test_quantize_and_dequantize_bit_equal_reference(case):
    w = _matrix(case)
    ref = jax_quant.quantize_int4
    if w.ndim == 3:
        want_p, want_s = jax.vmap(lambda m: ref(m, 64))(jnp.asarray(w))
    else:
        want_p, want_s = ref(jnp.asarray(w), 64)
    got_p, got_s = quant.quantize_int4(torch.from_numpy(w), 64)
    assert got_p.dtype == torch.uint8 and got_s.dtype == torch.bfloat16
    assert np.array_equal(_bits(got_p), _bits(want_p))
    assert np.array_equal(_bits(got_s), _bits(want_s))
    deq = jax_quant.dequantize_int4
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        if w.ndim == 3:
            want = jax.vmap(lambda p, s: deq(p, s, dtype=jdt))(want_p, want_s)
        else:
            want = deq(want_p, want_s, dtype=jdt)
        got = quant.dequantize_int4(got_p, got_s, dtype=tdt)
        assert np.array_equal(_bits(got), _bits(want)), tdt


def test_quantize_refuses_a_ragged_block():
    with pytest.raises(ValueError, match="must divide by even block_size"):
        quant.quantize_int4(torch.zeros(96, 8), 64)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_int4_matmul_forward_and_grad_x_match_jax_grad(lead):
    """``x @ W`` and ``grad_x`` against ``jax.grad`` of the reference's
    dequantize-then-matmul, f32, atol 1e-6 (the expert stack batched)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal(lead + (128, 24)).astype(np.float32)
    x = rng.standard_normal(lead + (7, 128)).astype(np.float32)
    cot = rng.standard_normal(lead + (7, 24)).astype(np.float32)
    packed, scales = quant.quantize_int4(torch.from_numpy(w))
    jp, js = jnp.asarray(packed.numpy()), jnp.asarray(scales.float().numpy()).astype(jnp.bfloat16)
    def dequant(p, s):
        return jax_quant.dequantize_int4(p, s, dtype=jnp.float32)

    if lead:
        dequant = jax.vmap(dequant)

    def f(xj):
        return jnp.sum((xj @ dequant(jp, js)) * cot)

    want_y = jnp.asarray(x) @ dequant(jp, js)
    want_g = jax.grad(f)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = quant.int4_matmul(xt, packed, scales, torch.float32)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-6, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), atol=1e-6, rtol=0)


def test_int4_projection_saves_no_dequantized_weight():
    """An int4 LoRA projection's graph keeps the packed base, its scales and
    the adapter's operands for the backward, never an (in, out) float
    kernel."""
    proj = LoRADense(128, 96, lora_rank=4, dtype=torch.bfloat16, quantize_base=True)
    with torch.no_grad():
        proj.lora_a.normal_()
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    x = torch.randn(2, 5, 128, dtype=torch.bfloat16, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = proj(x)
    y.float().sum().backward()
    assert x.grad is not None and proj.lora_b.grad is not None
    assert ((64, 96), torch.uint8) in saved and ((2, 96), torch.bfloat16) in saved
    assert not [s for s in saved if s[0] == (128, 96)], saved


def test_full_fine_tune_of_an_int4_base_is_refused():
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = PRESETS["tiny-test"].replace(quantize_base=True)
    with pytest.raises(ValueError, match="cannot train an int4-quantized base"):
        Trainer(cfg, TrainConfig(mode="full"), device="cpu")


def _qlora_variables(seed: int):
    """The reference's QLoRA ``tiny-test`` tree (f32 compute, rank 4): its
    own int4 draw, every float leaf replaced by seeded noise."""
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, quantize_base=True,
                                            lora=JaxLoRAConfig(rank=4, alpha=8.0))
    variables = jax.device_get(JaxLlama(jcfg).init({"params": jax.random.PRNGKey(1)},
                                                   jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.default_rng(seed)
    noisy = jax.tree_util.tree_map(
        lambda x: (np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32)
                   if np.asarray(x).dtype == np.float32 else np.asarray(x)), variables)
    return jcfg, noisy


def test_qlora_model_logits_and_lora_grads_match_reference():
    """Logits within 1e-4 and every LoRA gradient within rel 1e-4 of its
    largest element, f32, on the same int4 base and adapters."""
    jcfg, variables = _qlora_variables(2)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 12)).astype(np.int32)
    jmodel = JaxLlama(jcfg)

    def loss(lora):
        logits = jmodel.apply({**variables, "lora": lora}, jnp.asarray(tokens))
        return jnp.sum(logits * jnp.linspace(-1.0, 1.0, logits.shape[-1])), logits

    # one compile for the logits and the gradients
    (_, want_logits), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["lora"])
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, quantize_base=True,
                                       lora=LoRAConfig(rank=4, alpha=8.0))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    logits = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    (logits * torch.linspace(-1.0, 1.0, logits.shape[-1])).sum().backward()
    got = {n: p.grad for n, p in model.named_parameters() if n.endswith((".lora_a", ".lora_b"))}
    got = to_flax(got, cfg)["lora"]
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want) == 7 * 2  # layer-stacked leaves
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def qlora_job(tmp_path_factory):
    from finetune_controller_tpu_torch.train import cli

    art = tmp_path_factory.mktemp("qlora") / "art"
    spec = {"model": {"preset": "tiny-test", "lora": {"rank": 4},
                      "overrides": {"quantize_base": True}},
            "training": {"total_steps": 3, "batch_size": 4, "seq_len": 16, "log_every": 1,
                         "checkpoint_every": 3, "warmup_steps": 1, "learning_rate": 0.02,
                         "seed": 7},
            "dataset": {"synthetic": {"task": "increment"}}, "artifacts_dir": str(art)}
    cli.run_job(spec, "cpu")
    return art, spec


def test_qlora_job_trains_and_the_loader_serves_the_same_int4_base(qlora_job):
    """The CLI trains a QLoRA ``tiny-test`` (bf16 compute, no
    ``frozen_dtype``); the loader rebuilds the int4 base bit for bit from
    the job's seed and serves it unmerged, and its bf16 embedding is the
    trainer's f32 draw rounded to bf16."""
    from finetune_controller_tpu_torch.serve.loader import load_serving_model, stage_meta
    from finetune_controller_tpu_torch.train import cli
    from finetune_controller_tpu_torch.train.trainer import Trainer

    art, spec = qlora_job
    rows = (art / "metrics.csv").read_text().splitlines()
    assert len(rows) == 4 and (art / "done.txt").exists() and (art / "adapter").is_dir()
    trainer = Trainer(cli.build_model_config(spec), cli.build_train_config(spec), device="cpu")
    trained = trainer.model.state_dict()
    served, meta = load_serving_model(art, merge_lora=True, device="cpu")
    assert meta["lora_merged"] is False and stage_meta(art)["lora_merged"] is False
    state = served.state_dict()
    int4 = [k for k in trained if k.endswith(("_packed", "_scales"))]
    assert len(int4) == 2 * 7 * 2
    for key in int4:
        assert state[key].dtype == trained[key].dtype
        assert torch.equal(state[key], trained[key]), key
    emb = "embed_tokens.embedding"
    assert trained[emb].dtype == torch.float32 and state[emb].dtype == torch.bfloat16
    assert torch.equal(state[emb], trained[emb].to(torch.bfloat16))
    # the served adapters are the checkpoint's
    assert any(k.endswith(".lora_b") and v.abs().max() > 0 for k, v in state.items())
