"""The port's decoder against the JAX reference on the same weights.

Each tiny preset is initialised in JAX, every leaf is replaced by seeded
numpy noise (so biases, LoRA ``B`` and norm scales are not trivially zero or
one), and the tree goes through ``from_flax`` into the port.  Full-forward
logits are compared:

* f32 (``dtype=float32``): only summation order differs — 1e-5;
* bf16 compute (f32 params, as the reference trains): the frameworks round
  intermediates at different places (JAX casts a Python scale to bf16
  before multiplying, PyTorch multiplies in f32 then rounds), so logits of
  magnitude ~1-5 after two layers may differ by a few bf16 ulps —
  atol = rtol = 6e-2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
    rope_inv_freqs as jax_rope_inv_freqs,
)
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.serve.loader import merge_lora_variables
from finetune_controller_tpu_torch.models.convert import from_flax, merge_lora, to_flax
from finetune_controller_tpu_torch.models.llama import (
    PRESETS,
    LlamaConfig,
    LlamaForCausalLM,
    rope_inv_freqs,
)
from finetune_controller_tpu_torch.models.lora import LoRAConfig

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (6e-2, 6e-2)}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (preset, lora rank, scan_layers): the scanned and unscanned layouts, qkv
# biases, tied embeddings and the Gemma knobs are all covered
MODELS = [("tiny-test", 4, True), ("tiny-qwen-test", 0, False), ("tiny-gemma-test", 2, True)]


def _noisy_variables(cfg, seed):
    variables = JaxLlama(cfg).init({"params": jax.random.PRNGKey(0)},
                                   jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    noisy = [np.asarray(0.1 + 0.3 * rng.standard_normal(leaf.shape), np.float32)
             for leaf in leaves]
    return jax.tree_util.tree_unflatten(treedef, noisy)


def _port(cfg_jax_name, rank, dtype, **kw):
    lora = LoRAConfig(rank=rank) if rank else LoRAConfig()
    return PRESETS[cfg_jax_name].replace(dtype=_TORCH[dtype], lora=lora, **kw)


def _jax_cfg(name, rank, scan, dtype):
    lora = JaxLoRAConfig(rank=rank) if rank else JaxLoRAConfig()
    return JAX_PRESETS[name].replace(dtype=_JAX[dtype], lora=lora, scan_layers=scan)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, (2, 12)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,rank,scan", MODELS)
def test_logits_match_reference(name, rank, scan, dtype, tokens):
    jcfg = _jax_cfg(name, rank, scan, dtype)
    variables = _noisy_variables(jcfg, seed=len(name))
    want = JaxLlama(jcfg).apply(variables, jnp.asarray(tokens))
    model = LlamaForCausalLM(_port(name, rank, dtype), device="cpu")
    model.load_state_dict(from_flax(variables, model.cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def test_merge_lora_matches_reference(tokens):
    jcfg = _jax_cfg("tiny-test", 4, True, "float32")
    variables = _noisy_variables(jcfg, seed=5)
    merged_jcfg, merged_vars = merge_lora_variables(jcfg, variables)
    cfg = _port("tiny-test", 4, "float32")
    merged_cfg, state = merge_lora(cfg, from_flax(variables, cfg))
    assert merged_cfg.lora.rank == 0 and merged_jcfg.lora.rank == 0
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in state)
    want_state = from_flax(merged_vars, merged_cfg)
    assert state.keys() == want_state.keys()
    for key in state:
        torch.testing.assert_close(state[key], want_state[key], atol=1e-6, rtol=1e-6)
    # the merged model reproduces the adapter model's logits
    merged = LlamaForCausalLM(merged_cfg, device="cpu")
    merged.load_state_dict(state)
    with torch.no_grad():
        got = merged(torch.from_numpy(tokens).long())
    want = JaxLlama(jcfg).apply(variables, jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_merge_lora_refuses_quantized_base():
    cfg = _port("tiny-test", 4, "float32").replace(quantize_base=True)
    with pytest.raises(ValueError, match="int4"):
        merge_lora(cfg, {"layers.0.attn.q_proj.lora_a": torch.zeros(1)})


@pytest.mark.parametrize("name", ["llama3-8b", "llama3.2-1b", "gemma-2b"])
def test_rope_inv_freqs_match_reference(name):
    """Plain and llama3-scaled schedules, f32."""
    got = rope_inv_freqs(PRESETS[name]).numpy()
    want = np.asarray(jax_rope_inv_freqs(JAX_PRESETS[name]))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("segments", [False, True])
def test_causal_attention_matches_reference(segments):
    """The plain full-sequence attention, with and without packing segment
    ids, f32."""
    from finetune_controller_tpu.ops.attention import xla_causal_attention as jax_attn
    from finetune_controller_tpu_torch.ops.attention import xla_causal_attention

    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 9, 4, 16), np.float32)
    k = rng.standard_normal((2, 9, 2, 16), np.float32)
    v = rng.standard_normal((2, 9, 2, 16), np.float32)
    seg = np.repeat(np.array([[0, 0, 1], [0, 1, 1]]), 3, axis=1).astype(np.int32)
    kw_j = {"segment_ids": jnp.asarray(seg)} if segments else {}
    kw_t = {"segment_ids": torch.from_numpy(seg)} if segments else {}
    want = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j)
    got = xla_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_config_fields_match_reference():
    """One spec fits both packages: the same field names, the same preset
    values apart from the dtypes and the nested LoRA config."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(LlamaConfig)]
    assert names == [f.name for f in dataclasses.fields(type(JAX_PRESETS["tiny-test"]))]
    assert PRESETS.keys() == JAX_PRESETS.keys()
    skip = {"dtype", "param_dtype", "lora"}
    for key, cfg in PRESETS.items():
        for name in names:
            if name not in skip:
                assert getattr(cfg, name) == getattr(JAX_PRESETS[key], name), (key, name)


def test_unported_configs_are_refused():
    """An MoE model builds (it trains); the serving engine refuses it with
    the reference engine's message (``engine.py:237-241``)."""
    from finetune_controller_tpu_torch.serve.engine import BatchEngine

    model = LlamaForCausalLM(PRESETS["tiny-moe-test"], device="cpu")
    assert model.layers[0].moe.n_experts == 4
    with pytest.raises(ValueError, match="does not serve MoE configs: expert-capacity "
                                         "routing couples batch rows"):
        BatchEngine(model)


def test_segment_forward_matches_reference(tokens):
    """The training forward with packing segment ids, f32, against the JAX
    ``apply`` with the same ids (1e-5)."""
    jcfg = _jax_cfg("tiny-test", 4, True, "float32")
    variables = _noisy_variables(jcfg, seed=11)
    seg = np.repeat(np.array([[1, 1, 2], [1, 2, 3]]), 4, axis=1).astype(np.int32)
    want = JaxLlama(jcfg).apply(variables, jnp.asarray(tokens), segment_ids=jnp.asarray(seg))
    model = LlamaForCausalLM(_port("tiny-test", 4, "float32"), device="cpu")
    model.load_state_dict(from_flax(variables, model.cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _loss_and_grads(model, tokens, seg=None):
    model.zero_grad()
    logits = model(tokens, segment_ids=seg)
    loss = torch.log_softmax(logits, -1)[..., 0].mean()
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("policy", ["full", "mlp"])
def test_remat_keeps_numerics(policy, dropout, tokens):
    """Loss and gradients under ``full``/``mlp`` remat equal ``none``'s
    exactly, dropout included (each adapter redraws its mask from its own
    seeded generator when the checkpointed region reruns)."""
    jcfg = _jax_cfg("tiny-test", 4, True, "float32")
    variables = _noisy_variables(jcfg, seed=12)
    seg = torch.from_numpy(np.repeat(np.array([[1, 2], [1, 1]]), 6, axis=1).astype(np.int32))
    results = []
    for name in ("none", policy):
        cfg = _port("tiny-test", 4, "float32", remat_policy=name).replace(
            lora=LoRAConfig(rank=4, dropout=dropout))
        model = LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(from_flax(variables, cfg))
        model.set_dropout_seed(5)
        results.append(_loss_and_grads(model, torch.from_numpy(tokens).long(), seg))
    (loss0, grads0), (loss1, grads1) = results
    assert loss0 == loss1 and grads0.keys() == grads1.keys()
    for key in grads0:
        torch.testing.assert_close(grads1[key], grads0[key], atol=0, rtol=0)


def test_lora_dropout_is_seeded_and_off_in_eval(tokens):
    cfg = _port("tiny-test", 4, "float32").replace(lora=LoRAConfig(rank=4, dropout=0.5))
    jcfg = _jax_cfg("tiny-test", 4, True, "float32")
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_flax(_noisy_variables(jcfg, seed=13), cfg))
    x = torch.from_numpy(tokens).long()
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="set_dropout_seed"):
            model(x)
        outs = []
        for seed in (1, 1, 2):
            model.set_dropout_seed(seed)
            outs.append(model(x))
        plain = model.eval()(x)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], plain)


@pytest.mark.parametrize("policy,error", [("bogus", ValueError)])
def test_unported_remat_policies_raise(policy, error, tokens):
    """An unknown policy raises the reference's message (every named policy
    runs since the remaining ones were ported: ``tests/test_torch_remat.py``)."""
    model = LlamaForCausalLM(_port("tiny-test", 2, "float32", remat_policy=policy),
                             device="cpu")
    with pytest.raises(error, match="remat_policy"):
        model(torch.from_numpy(tokens).long())
    with torch.no_grad():  # no gradients recorded: nothing to rematerialise
        model(torch.from_numpy(tokens).long())


@pytest.mark.parametrize("scan", [True, False])
def test_to_flax_inverts_from_flax(scan):
    jcfg = _jax_cfg("tiny-qwen-test", 2, scan, "float32")
    variables = _noisy_variables(jcfg, seed=14)
    cfg = PRESETS["tiny-qwen-test"].replace(lora=LoRAConfig(rank=2), scan_layers=scan)
    back = to_flax(from_flax(variables, cfg), cfg)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf))
