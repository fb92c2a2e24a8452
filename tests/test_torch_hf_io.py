"""The port's HF checkpoint import and export against the JAX package's and
against ``transformers``/``peft``, on tiny checkpoints written from local
configs (no download).

* import: the port's ``load_llama_params`` EQUALS the JAX
  ``load_llama_params`` followed by ``from_flax``, bit for bit, for a Llama
  (untied and tied), a Qwen-2 with q/k/v biases and a Gemma, from
  safetensors, from ``pytorch_model.bin`` and from a sharded directory;
  ``load_pretrained_`` fills a model with the same tensors;
* the imported model's logits against ``transformers``' own forward: the
  reference's tolerances (Llama atol 2e-4, Qwen-2/Gemma 5e-4, rtol 1e-3);
* a wrong layer count, an unexpected tensor and a missing ``lm_head`` raise
  the reference's messages, word for word;
* ``export_lora_adapter`` writes the JAX exporter's tensors bit for bit and
  its ``adapter_config.json``; ``peft`` loads it and gives the port's
  unmerged logits (atol 1e-4);
* ``export_merged_checkpoint`` writes the JAX exporter's tensors within
  atol 1e-6 (the merge's matmul orders differ) and its ``config.json``,
  the llama3 ``rope_scaling`` block included; ``transformers`` loads it and
  gives the port's merged logits (the reference's tolerances);
* export then import round-trips;
* Mixtral: a ``transformers`` checkpoint imports to the JAX tree bit for
  bit; ``load_pretrained_`` into an int4 model (QLoRA base, int4 experts)
  equals the reference's ``_adapt_loaded_params`` bit for bit; the merged
  exports of a QLoRA and an int4-expert MoE model equal the JAX exporter's
  (atol 1e-6), the MoE adapter its files bit for bit.
"""

from __future__ import annotations

import json
import os

os.environ.setdefault("USE_TF", "0")  # transformers: skip the TensorFlow import

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from safetensors import safe_open  # noqa: E402
from safetensors.torch import save_file as st_save  # noqa: E402

from finetune_controller_tpu.models import hf_export as jax_export  # noqa: E402
from finetune_controller_tpu.models import hf_import as jax_import  # noqa: E402
from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS  # noqa: E402
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig  # noqa: E402
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax  # noqa: E402
from finetune_controller_tpu_torch.models.hf_export import (  # noqa: E402
    export_lora_adapter,
    export_merged_checkpoint,
    export_mm_projector,
)
from finetune_controller_tpu_torch.models.hf_import import (  # noqa: E402
    load_llama_params,
    load_llava_params,
    load_pretrained_,
)
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM  # noqa: E402
from finetune_controller_tpu_torch.models.lora import LoRAConfig  # noqa: E402

torch.set_num_threads(1)

#: family -> (preset, tie_embeddings, logits atol) — the reference's tolerances
FAMILIES = {
    "llama": ("tiny-test", False, 2e-4),
    "llama-tied": ("tiny-test", True, 2e-4),
    "qwen2": ("tiny-qwen-test", False, 5e-4),
    "gemma": ("tiny-gemma-test", True, 5e-4),
}
TOKENS = np.random.default_rng(0).integers(0, 256, (2, 16))


def port_cfg(family: str, rank: int = 0):
    preset, tie, _ = FAMILIES[family]
    return PRESETS[preset].replace(dtype=torch.float32, tie_embeddings=tie,
                                   lora=LoRAConfig(rank=rank, alpha=8.0))


def jax_cfg(family: str, rank: int = 0):
    preset, tie, _ = FAMILIES[family]
    return JAX_PRESETS[preset].replace(dtype=jnp.float32, tie_embeddings=tie,
                                       lora=JaxLoRAConfig(rank=rank, alpha=8.0))


def _hf_model(family: str):
    import transformers as tf

    cfg = port_cfg(family)
    common = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
                  num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
                  num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.d_ff,
                  rms_norm_eps=cfg.rms_eps, rope_theta=cfg.rope_theta,
                  max_position_embeddings=cfg.max_seq_len,
                  tie_word_embeddings=cfg.tie_embeddings)
    torch.manual_seed(len(family))
    if family == "qwen2":
        model = tf.Qwen2ForCausalLM(tf.Qwen2Config(**common))
        with torch.no_grad():  # non-zero biases, so a lost bias shows
            for layer in model.model.layers:
                for p in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                          layer.self_attn.v_proj):
                    p.bias.normal_(0.0, 0.1)
    elif family == "gemma":
        model = tf.GemmaForCausalLM(tf.GemmaConfig(
            **common, head_dim=cfg.head_dim, hidden_activation="gelu_pytorch_tanh",
            attention_bias=False))
        with torch.no_grad():  # offset-form norms away from their zero init
            for name, p in model.named_parameters():
                if "norm" in name:
                    p.normal_(0.0, 0.1)
    else:
        model = tf.LlamaForCausalLM(tf.LlamaConfig(**common, attention_bias=False,
                                                   mlp_bias=False))
    return model.eval()


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """family -> (transformers model, safetensors checkpoint dir)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for family in FAMILIES:
        model = _hf_model(family)
        model.save_pretrained(str(root / family), safe_serialization=True)
        out[family] = (model, root / family)
    return out


def _jax_state(ckpt, family: str) -> dict[str, torch.Tensor]:
    params = jax_import.load_llama_params(ckpt, jax_cfg(family), dtype=jnp.float32)
    return from_flax({"params": params}, port_cfg(family))


def _assert_equal_states(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("family", FAMILIES)
def test_import_equals_jax_import_bit_for_bit(hf, family):
    _, ckpt = hf[family]
    got = load_llama_params(ckpt, port_cfg(family))
    _assert_equal_states(got, _jax_state(ckpt, family))
    # streamed into a built model, the same tensors land in its parameters
    model = LlamaForCausalLM(port_cfg(family), device="cpu")
    load_pretrained_(model, ckpt)
    _assert_equal_states({k: v for k, v in model.state_dict().items()}, got)


@pytest.mark.parametrize("family", FAMILIES)
def test_imported_logits_match_transformers(hf, family):
    hf_model, ckpt = hf[family]
    model = LlamaForCausalLM(port_cfg(family), device="cpu")
    model.load_state_dict(load_llama_params(ckpt, port_cfg(family)), strict=True)
    with torch.no_grad():
        want = hf_model(torch.tensor(TOKENS)).logits.float().numpy()
        got = model(torch.tensor(TOKENS)).numpy()
    np.testing.assert_allclose(got, want, atol=FAMILIES[family][2], rtol=1e-3)


@pytest.mark.parametrize("layout", ["bin", "sharded"])
def test_bin_and_sharded_checkpoints_import_equal(hf, tmp_path, layout):
    """``pytorch_model.bin`` (with the RoPE buffer old checkpoints carry) and
    a sharded safetensors directory with its index give the same state."""
    hf_model, ckpt = hf["llama"]
    out = tmp_path / layout
    if layout == "bin":
        hf_model.save_pretrained(str(out), safe_serialization=False)
        state = torch.load(out / "pytorch_model.bin", weights_only=True)
        state["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(8)
        torch.save(state, out / "pytorch_model.bin")
    else:
        hf_model.save_pretrained(str(out), safe_serialization=True, max_shard_size="100KB")
        assert (out / "model.safetensors.index.json").exists()
        assert len(list(out.glob("model-*-of-*.safetensors"))) > 1
    got = load_llama_params(out, port_cfg("llama"))
    _assert_equal_states(got, _jax_state(out, "llama"))
    _assert_equal_states(got, load_llama_params(ckpt, port_cfg("llama")))


def _bad_checkpoint(hf, tmp_path, case: str):
    """(checkpoint dir, family, n_layers) of one broken import."""
    if case == "missing lm_head":
        return hf["llama-tied"][1], "llama", None
    if case == "wrong layer count":
        return hf["llama"][1], "llama", 1
    _, ckpt = hf["llama"]
    with safe_open(str(ckpt / "model.safetensors"), "pt") as f:
        tensors = {k: f.get_tensor(k) for k in f.keys()}
    tensors["model.vision_proj.weight"] = torch.zeros(2, 2)
    (tmp_path / "bad").mkdir()
    st_save(tensors, str(tmp_path / "bad" / "model.safetensors"))
    return tmp_path / "bad", "llama", None


@pytest.mark.parametrize("case", ["wrong layer count", "unexpected tensor", "missing lm_head"])
def test_import_errors_match_the_reference_word_for_word(hf, tmp_path, case):
    ckpt, family, layers = _bad_checkpoint(hf, tmp_path, case)
    pcfg, jcfg = port_cfg(family), jax_cfg(family)
    if layers:
        pcfg, jcfg = pcfg.replace(n_layers=layers), jcfg.replace(n_layers=layers)
    with pytest.raises(ValueError) as want:
        jax_import.load_llama_params(ckpt, jcfg, dtype=jnp.float32)
    with pytest.raises(ValueError) as got:
        load_llama_params(ckpt, pcfg)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as streamed:
        load_pretrained_(LlamaForCausalLM(pcfg, device="cpu"), ckpt)
    assert str(streamed.value) == str(want.value)


def _lora_model(family: str, ckpt, seed: int = 7) -> LlamaForCausalLM:
    """The imported base with seeded non-zero adapters (rank 4, alpha 8)."""
    model = LlamaForCausalLM(port_cfg(family, rank=4), device="cpu")
    load_pretrained_(model, ckpt)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".lora_a", ".lora_b")):
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    return model.eval()


def _read(path) -> dict[str, torch.Tensor]:
    with safe_open(str(path), "pt") as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def test_adapter_export_equals_jax_and_loads_in_peft(hf, tmp_path):
    import peft

    hf_model, ckpt = hf["llama"]
    model = _lora_model("llama", ckpt)
    state = model.state_dict()
    export_lora_adapter(model.cfg, state, tmp_path / "port", base_model_name="base")
    variables = to_flax(state, model.cfg.replace(scan_layers=True))
    jax_export.export_lora_adapter(jax_cfg("llama", rank=4), variables["lora"],
                                   tmp_path / "jax", base_model_name="base")
    got, want = _read(tmp_path / "port" / "adapter_model.safetensors"), \
        _read(tmp_path / "jax" / "adapter_model.safetensors")
    _assert_equal_states(got, want)
    assert len(got) == 2 * 7 * 2
    assert json.loads((tmp_path / "port" / "adapter_config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "adapter_config.json").read_text())
    peft_model = peft.PeftModel.from_pretrained(hf_model, str(tmp_path / "port")).eval()
    with torch.no_grad():
        want_logits = peft_model(torch.tensor(TOKENS)).logits.float().numpy()
        got_logits = model(torch.tensor(TOKENS)).numpy()
    peft_model.unload()
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=0)


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma"])
def test_merged_export_equals_jax_and_loads_in_transformers(hf, tmp_path, family):
    from transformers import AutoModelForCausalLM

    _, ckpt = hf[family]
    model = _lora_model(family, ckpt)
    state = model.state_dict()
    export_merged_checkpoint(model.cfg, state, tmp_path / "port")
    jax_export.export_merged_checkpoint(
        jax_cfg(family, rank=4), to_flax(state, model.cfg.replace(scan_layers=True)),
        tmp_path / "jax")
    got, want = _read(tmp_path / "port" / "model.safetensors"), \
        _read(tmp_path / "jax" / "model.safetensors")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-6, rtol=0,
                                   err_msg=key)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == \
        json.loads((tmp_path / "jax" / "config.json").read_text())
    reloaded = AutoModelForCausalLM.from_pretrained(str(tmp_path / "port")).eval()
    with torch.no_grad():
        want_logits = reloaded(torch.tensor(TOKENS)).logits.float().numpy()
        got_logits = model(torch.tensor(TOKENS)).numpy()
    np.testing.assert_allclose(got_logits, want_logits, atol=FAMILIES[family][2], rtol=1e-3)


def test_merged_config_with_llama3_rope_scaling_equals_jax(tmp_path):
    """A rope-scaled Llama-3.x config: the port's ``config.json`` is the
    JAX exporter's, ``rope_scaling`` block included; a sharded bf16 export
    writes the hub's layout and reads back."""
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, rope_scaling_factor=32.0,
                                       rope_theta=500000.0)
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, rope_scaling_factor=32.0,
                                            rope_theta=500000.0)
    model = LlamaForCausalLM(cfg, device="cpu")
    from finetune_controller_tpu_torch.models.llama import init_random_

    init_random_(model, 3)
    state = model.state_dict()
    export_merged_checkpoint(cfg, state, tmp_path / "port")
    jax_export.export_merged_checkpoint(jcfg, to_flax(state, cfg.replace(scan_layers=True)),
                                        tmp_path / "jax")
    got = json.loads((tmp_path / "port" / "config.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "config.json").read_text())
    assert got["rope_scaling"]["rope_type"] == "llama3"
    export_merged_checkpoint(cfg, state, tmp_path / "shards", dtype=torch.bfloat16,
                             max_shard_bytes=40_000)
    index = json.loads((tmp_path / "shards" / "model.safetensors.index.json").read_text())
    files = sorted(set(index["weight_map"].values()))
    assert len(files) > 1 and files[0] == f"model-00001-of-{len(files):05d}.safetensors"
    back = load_llama_params(tmp_path / "shards", cfg, dtype=torch.bfloat16)
    _assert_equal_states(back, {k: v.to(torch.bfloat16) for k, v in state.items()})


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_export_then_import_round_trips(hf, tmp_path, family):
    """A rank-0 model exported merged reads back as the same state; with
    adapters, the import gives the merged kernels the loader merges."""
    _, ckpt = hf[family]
    base = load_llama_params(ckpt, port_cfg(family))
    export_merged_checkpoint(port_cfg(family), base, tmp_path / "plain")
    _assert_equal_states(load_llama_params(tmp_path / "plain", port_cfg(family)), base)
    model = _lora_model(family, ckpt)
    export_merged_checkpoint(model.cfg, model.state_dict(), tmp_path / "merged")
    from finetune_controller_tpu_torch.models.convert import merge_lora

    _, merged = merge_lora(model.cfg, model.state_dict())
    _assert_equal_states(load_llama_params(tmp_path / "merged", port_cfg(family)), merged)


def test_unported_layouts_raise_naming_their_item(hf, tmp_path):
    moe = PRESETS["tiny-moe-test"]
    # MoE imports and exports now; a dense checkpoint does not fit an MoE
    # config (the reference's KeyError, its first missing expert tensor),
    # and Gemma-semantics MoE matches no transformers architecture
    with pytest.raises(KeyError, match="block_sparse_moe.experts.0.w1.weight"):
        load_llama_params(hf["llama"][1], moe)
    with pytest.raises(NotImplementedError, match="Gemma-semantics MoE"):
        export_merged_checkpoint(moe.replace(norm_offset=1.0, embed_scale=True, mlp_act="gelu",
                                             tie_embeddings=True), {}, tmp_path / "moe")
    # LLaVA imports and exports now: a text checkpoint does not fit a LLaVA
    # config (the reference's ValueError, word for word), and a state
    # without a projector writes no projector file
    from finetune_controller_tpu.models.multimodal import MM_PRESETS as JAX_MM
    from finetune_controller_tpu_torch.models.multimodal import MM_PRESETS

    with pytest.raises(ValueError) as port_error:
        load_llava_params(hf["llama"][1], MM_PRESETS["tiny-mm-clip-test"])
    with pytest.raises(ValueError) as jax_error:
        jax_import.load_llava_params(hf["llama"][1], JAX_MM["tiny-mm-clip-test"])
    assert str(port_error.value) == str(jax_error.value)
    assert str(port_error.value).startswith("unexpected checkpoint tensors")
    with pytest.raises(KeyError, match="projector_fc1"):
        export_mm_projector({}, tmp_path / "mm")
    assert not (tmp_path / "mm" / "projector.safetensors").exists()
    # partial Gemma semantics refuse before any file is written (the
    # reference's message)
    with pytest.raises(NotImplementedError, match="adapter"):
        export_merged_checkpoint(port_cfg("llama").replace(embed_scale=True), {},
                                 tmp_path / "nope")
    assert not (tmp_path / "nope").exists()


# ---------------------------------------------------------------------------
# Mixtral and int4 bases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """A tiny Mixtral checkpoint (the ``tiny-moe-test`` shapes) written by
    ``transformers`` from a local ``MixtralConfig``."""
    import transformers as tf

    cfg = PRESETS["tiny-moe-test"]
    torch.manual_seed(5)
    model = tf.MixtralForCausalLM(tf.MixtralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        intermediate_size=cfg.d_ff, num_local_experts=cfg.n_experts,
        num_experts_per_tok=cfg.moe_top_k, max_position_embeddings=cfg.max_seq_len,
        rms_norm_eps=cfg.rms_eps, rope_theta=cfg.rope_theta, tie_word_embeddings=False))
    path = tmp_path_factory.mktemp("mixtral") / "ckpt"
    model.save_pretrained(str(path), safe_serialization=True)
    return path


def _moe_cfgs(quantize: bool, rank: int = 0):
    lora = dict(rank=rank, alpha=8.0)
    return (PRESETS["tiny-moe-test"].replace(dtype=torch.float32, quantize_base=quantize,
                                             lora=LoRAConfig(**lora)),
            JAX_PRESETS["tiny-moe-test"].replace(dtype=jnp.float32, quantize_base=quantize,
                                                 lora=JaxLoRAConfig(**lora)))


def test_mixtral_import_equals_jax_import_bit_for_bit(mixtral):
    """The experts stack as ``(E, in, out)`` (w1 gate, w2 down, w3 up), the
    router from ``block_sparse_moe.gate``: the JAX tree through
    ``from_flax``, bit for bit."""
    cfg, jcfg = _moe_cfgs(False)
    got = load_llama_params(mixtral, cfg)
    want = from_flax({"params": jax_import.load_llama_params(mixtral, jcfg, dtype=jnp.float32)},
                     cfg)
    _assert_equal_states(got, want)
    assert got["layers.1.moe.experts_down"].shape == (4, 128, 64)


@pytest.mark.parametrize("family", ["qlora", "moe"])
def test_load_pretrained_quantizes_as_the_reference_adapts(hf, mixtral, family):
    """``load_pretrained_`` into an int4 model equals the reference's
    ``_adapt_loaded_params`` (quantize every kernel the model stores as
    int4), bit for bit, for the dense QLoRA base and the int4 experts."""
    import jax

    from finetune_controller_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from finetune_controller_tpu.train.trainer import _adapt_loaded_params

    if family == "qlora":
        cfg = port_cfg("llama").replace(quantize_base=True)
        jcfg, ckpt = jax_cfg("llama").replace(quantize_base=True), hf["llama"][1]
    else:
        (cfg, jcfg), ckpt = _moe_cfgs(True), mixtral
    # the initialised tree's shapes and dtypes are all the adapter reads
    target = jax.eval_shape(lambda: JaxLlama(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32)))["params"]
    loaded = jax_import.load_llama_params(ckpt, jcfg, dtype=jnp.float32)
    adapted = _adapt_loaded_params(loaded, target, quant_block=64)
    want = from_flax({"params": adapted}, cfg)
    model = load_pretrained_(LlamaForCausalLM(cfg, device="cpu"), ckpt)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    assert sum(k.endswith("_packed") for k in got) == (14 if family == "qlora" else 2 * 4 + 6)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("family", ["qlora", "moe"])
def test_int4_and_moe_exports_equal_jax(hf, mixtral, tmp_path, family):
    """The merged export of a QLoRA model (dequantized base + adapters) and
    of an int4-expert MoE model (experts unstacked to w1/w2/w3, dequantized;
    the Mixtral ``config.json`` keys) within atol 1e-6 of the reference
    exporter's; the MoE adapter (attention projections only) bit for bit."""
    if family == "qlora":
        cfg, jcfg, ckpt = (port_cfg("llama", rank=4).replace(quantize_base=True),
                           jax_cfg("llama", rank=4).replace(quantize_base=True), hf["llama"][1])
    else:
        (cfg, jcfg), ckpt = _moe_cfgs(True, rank=4), mixtral
    model = load_pretrained_(LlamaForCausalLM(cfg, device="cpu"), ckpt)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".lora_a", ".lora_b")):
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    state = model.state_dict()
    variables = to_flax(state, cfg.replace(scan_layers=True))
    export_merged_checkpoint(cfg, state, tmp_path / "port")
    jax_export.export_merged_checkpoint(jcfg, variables, tmp_path / "jax")
    got, want = _read(tmp_path / "port" / "model.safetensors"), \
        _read(tmp_path / "jax" / "model.safetensors")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-6, rtol=0,
                                   err_msg=key)
    config = json.loads((tmp_path / "port" / "config.json").read_text())
    assert config == json.loads((tmp_path / "jax" / "config.json").read_text())
    if family == "qlora":
        return
    assert config["num_local_experts"] == 4 and config["architectures"] == ["MixtralForCausalLM"]
    export_lora_adapter(cfg, state, tmp_path / "port_adapter")
    jax_export.export_lora_adapter(jcfg, variables["lora"], tmp_path / "jax_adapter")
    got = _read(tmp_path / "port_adapter" / "adapter_model.safetensors")
    _assert_equal_states(got, _read(tmp_path / "jax_adapter" / "adapter_model.safetensors"))
    assert len(got) == 2 * 4 * 2
    assert json.loads((tmp_path / "port_adapter" / "adapter_config.json").read_text()) == \
        json.loads((tmp_path / "jax_adapter" / "adapter_config.json").read_text())
