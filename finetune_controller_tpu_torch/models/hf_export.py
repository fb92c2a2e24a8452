"""Export trained artifacts in HuggingFace-consumable formats (counterpart of
the reference's ``models/hf_export.py:28-299``).

The other half of ``hf_import.py``: after a fine-tune the trainer writes
either a **PEFT adapter** directory (``adapter_model.safetensors`` +
``adapter_config.json``, loadable with ``peft.PeftModel``) or a **merged
full checkpoint** (``model.safetensors`` + ``config.json``, loadable with
``transformers``), for dense Llama, Qwen-2, Gemma and Mixtral (the stacked
experts unstacked to per-expert ``w1/w2/w3``, the router as
``block_sparse_moe.gate``).  An int4 base (QLoRA) exports dequantized, in
f32 (the reference's ``_base_kernel``/``_expert_stack``); an MoE model's
adapter holds the attention projections only, where its LoRA lives.  Both read the port's
state dict (``LlamaForCausalLM.state_dict()`` names, tensors on any
device); every key of ``config.json`` and ``adapter_config.json`` is the
reference's.

Files are written through ``models/safetensors_io.StreamWriter``: the
header is computed from the config's shapes and each tensor is produced,
moved to the host and written one at a time, so an 8B merged export never
holds the 32 GB f32 dict the reference builds.  Merging uses
``models/convert.merge_kernel``, as the serving loader does.  A LLaVA
run exports its decoder's adapter under ``hf_prefix``
``base_model.model.language_model.model.layers`` and the trained projector
beside it (:func:`export_mm_projector`).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Iterator, Mapping

import torch

from .convert import merge_kernel
from .quant import dequantize_int4
from .safetensors_io import INDEX_FILENAME, StreamWriter

logger = logging.getLogger(__name__)

#: our projection name → HF module path fragment
_HF_MODULE = {
    "q_proj": "self_attn.q_proj",
    "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj",
    "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj",
    "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}
_GROUP = {p: "attn" if m.startswith("self_attn") else "mlp" for p, m in _HF_MODULE.items()}
_ST_METADATA = {"format": "pt"}


#: the stacked expert kernels -> Mixtral's per-expert weight names, in the
#: reference's export order (the importer's w1=gate / w2=down / w3=up)
_HF_EXPERTS = (("experts_gate", "w1"), ("experts_down", "w2"), ("experts_up", "w3"))


def _base_kernel(state: Mapping[str, torch.Tensor], stem: str) -> torch.Tensor:
    """The f32 base kernel ``stem`` (a projection's ``kernel``, or an
    ``(E, in, out)`` expert stack), dequantizing int4 storage."""
    if stem in state:
        return state[stem].to(torch.float32)
    return dequantize_int4(state[f"{stem}_packed"], state[f"{stem}_scales"],
                           dtype=torch.float32)


def _write(path: Path, specs: list[tuple[str, torch.dtype, tuple]],
           produce: Iterator[tuple[str, torch.Tensor]]) -> int:
    """Stream ``produce``'s tensors into one file declared by ``specs``."""
    with StreamWriter(path, specs, _ST_METADATA) as writer:
        for name, tensor in produce:
            writer.write(name, tensor)
    return writer.nbytes


def export_lora_adapter(
    cfg,
    state: Mapping[str, torch.Tensor],
    out_dir: Path | str,
    *,
    base_model_name: str = "",
    hf_prefix: str = "base_model.model.model.layers",
) -> Path:
    """Write a PEFT-format LoRA adapter directory from the ``lora_a`` /
    ``lora_b`` entries of ``state``.

    PEFT stores ``lora_A.weight (r, in)`` / ``lora_B.weight (out, r)`` per
    target module with scaling ``alpha / r``; ours are ``(in, r)`` /
    ``(r, out)`` with the same scaling, so the export is a transpose per
    tensor, written in f32."""
    out_dir = Path(out_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = []  # (hf name, port key)
    modules: set[str] = set()
    for i in range(cfg.n_layers):
        for proj, hf in _HF_MODULE.items():
            key = f"layers.{i}.{_GROUP[proj]}.{proj}"
            if f"{key}.lora_a" not in state:
                continue
            modules.add(proj)
            prefix = f"{hf_prefix}.{i}.{hf}"
            entries += [(f"{prefix}.lora_A.weight", f"{key}.lora_a"),
                        (f"{prefix}.lora_B.weight", f"{key}.lora_b")]
    specs = [(hf, torch.float32, tuple(reversed(state[key].shape))) for hf, key in entries]
    _write(out_dir / "adapter_model.safetensors", specs,
           ((hf, state[key].to(torch.float32).T) for hf, key in entries))

    adapter_config = {
        "peft_type": "LORA",
        "task_type": "CAUSAL_LM",
        "base_model_name_or_path": base_model_name,
        "r": cfg.lora.rank,
        "lora_alpha": cfg.lora.alpha,
        "lora_dropout": cfg.lora.dropout,
        "target_modules": sorted(modules),
        "bias": "none",
        "fan_in_fan_out": False,
        "inference_mode": True,
    }
    (out_dir / "adapter_config.json").write_text(json.dumps(adapter_config, indent=2))
    logger.info("wrote PEFT adapter (%d tensors) -> %s", len(entries), out_dir)
    return out_dir


#: HF's ``multi_modal_projector`` tensors -> the port's projector leaves
_HF_PROJECTOR = (("multi_modal_projector.linear_1.weight", "projector_fc1.kernel"),
                 ("multi_modal_projector.linear_1.bias", "projector_fc1.bias"),
                 ("multi_modal_projector.linear_2.weight", "projector_fc2.kernel"),
                 ("multi_modal_projector.linear_2.bias", "projector_fc2.bias"))


def export_mm_projector(state: Mapping[str, torch.Tensor], out_dir: Path | str) -> Path:
    """Write the trained LLaVA projector (``projector_fc{1,2}`` of
    ``state``) beside the adapter as ``projector.safetensors``, in f32 and
    HF's ``multi_modal_projector`` naming (weights ``(out, in)``)."""
    out_dir = Path(out_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)

    def hf(name: str, key: str) -> torch.Tensor:
        t = state[key].to(torch.float32)
        return t.T if name.endswith(".weight") else t

    specs = [(name, torch.float32, tuple(hf(name, key).shape)) for name, key in _HF_PROJECTOR]
    path = out_dir / "projector.safetensors"
    _write(path, specs, ((name, hf(name, key)) for name, key in _HF_PROJECTOR))
    logger.info("wrote multimodal projector -> %s", path)
    return path


def _hf_layout(cfg) -> tuple[str, str]:
    """(architecture, model_type) for the config's semantics; raises on
    combinations no HF architecture encodes."""
    gemma_markers = (cfg.norm_offset, cfg.embed_scale, cfg.mlp_act != "silu")
    if any(gemma_markers):
        # Gemma semantics: HF stores the SAME offset-form norm weights and
        # applies the same sqrt(d) embed scaling/GeGLU from config, so the
        # tensors export unchanged — only the config names the architecture
        if not all([cfg.norm_offset == 1.0, cfg.embed_scale,
                    cfg.mlp_act == "gelu", cfg.tie_embeddings]):
            raise NotImplementedError(
                "partial Gemma semantics (norm_offset/embed_scale/mlp_act "
                "mix) matches no transformers architecture; export the PEFT "
                "adapter instead"
            )
        if cfg.n_experts:
            raise NotImplementedError(
                "Gemma-semantics MoE matches no transformers architecture"
            )
        arch, model_type = "GemmaForCausalLM", "gemma"
    elif cfg.n_experts:
        arch, model_type = "MixtralForCausalLM", "mixtral"
    elif cfg.attention_qkv_bias:
        arch, model_type = "Qwen2ForCausalLM", "qwen2"
    else:
        arch, model_type = "LlamaForCausalLM", "llama"
    if cfg.rope_scaling_factor and model_type != "llama":
        # only the Llama-3.x presets carry rope_scaling today; another
        # layout with it set would get a config.json whose llama3
        # rope_scaling block transformers rejects — refuse BEFORE any
        # tensor file is written
        raise NotImplementedError(
            f"rope_scaling export is only supported for the llama layout, "
            f"not {model_type!r}"
        )
    return arch, model_type


def hf_config(cfg, dtype: torch.dtype = torch.float32) -> dict:
    """``config.json`` of a merged checkpoint (the reference's keys;
    ``torch_dtype`` names the tensors' dtype)."""
    arch, model_type = _hf_layout(cfg)
    config = {
        "architectures": [arch],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.d_model,
        "intermediate_size": cfg.d_ff,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        # explicit so a decoupled head_dim (head_dim_override) reconstructs
        # the same attention shapes in transformers
        "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.rms_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": cfg.tie_embeddings,
        "attention_bias": cfg.attention_qkv_bias,
        "mlp_bias": False,
        "torch_dtype": str(dtype).removeprefix("torch."),
    }
    if model_type == "gemma":
        # transformers' Gemma applies GeGLU (tanh approximation), the (1+w)
        # norm form, and sqrt(d) embed scaling from the architecture itself —
        # both config keys are set for pre/post-4.39 transformers
        config["hidden_act"] = "gelu_pytorch_tanh"
        config["hidden_activation"] = "gelu_pytorch_tanh"
    if model_type == "mixtral":
        config["num_local_experts"] = cfg.n_experts
        config["num_experts_per_tok"] = cfg.moe_top_k
        config["router_aux_loss_coef"] = cfg.router_aux_weight
    if cfg.rope_scaling_factor:
        # non-llama layouts were refused in _hf_layout, before any write
        config["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": cfg.rope_scaling_factor,
            "low_freq_factor": cfg.rope_scaling_low_freq_factor,
            "high_freq_factor": cfg.rope_scaling_high_freq_factor,
            "original_max_position_embeddings": cfg.rope_scaling_original_max_len,
        }
    return config


def _merged_entries(cfg, state: Mapping[str, torch.Tensor]):
    """``(hf_name, shape, produce)`` of every merged tensor, in HF order;
    ``produce()`` returns the f32 tensor in HF layout on ``state``'s device."""
    scale = cfg.lora.alpha / cfg.lora.rank if cfg.lora.rank else 0.0

    def plain(key):
        return lambda: state[key].to(torch.float32)

    def kernel(key):
        def produce():
            w = _base_kernel(state, f"{key}.kernel")                  # (in, out)
            if f"{key}.lora_a" in state:
                w = merge_kernel(w, state[f"{key}.lora_a"], state[f"{key}.lora_b"], scale)
            return w.T
        return produce

    def expert(stem, e):
        # one expert's f32 kernel; an int4 stack dequantizes that expert only
        if stem in state:
            return lambda: state[stem][e].to(torch.float32).T
        return lambda: dequantize_int4(state[f"{stem}_packed"][e], state[f"{stem}_scales"][e],
                                       dtype=torch.float32).T

    def kernel_shape(stem):                                           # (in, out)
        if stem in state:
            return tuple(state[stem].shape[-2:])
        packed = state[f"{stem}_packed"]
        return (packed.shape[-2] * 2, packed.shape[-1])

    emb = state["embed_tokens.embedding"]
    yield "model.embed_tokens.weight", tuple(emb.shape), plain("embed_tokens.embedding")
    for i in range(cfg.n_layers):
        prefix = f"model.layers.{i}"
        for hf, leaf in (("input_layernorm", "attn_norm"),
                         ("post_attention_layernorm", "mlp_norm")):
            key = f"layers.{i}.{leaf}.scale"
            yield f"{prefix}.{hf}.weight", tuple(state[key].shape), plain(key)
        for proj, hf in _HF_MODULE.items():
            if cfg.n_experts and _GROUP[proj] == "mlp":
                continue
            key = f"layers.{i}.{_GROUP[proj]}.{proj}"
            yield (f"{prefix}.{hf}.weight", tuple(reversed(kernel_shape(f"{key}.kernel"))),
                   kernel(key))
            if f"{key}.bias" in state:  # Qwen-2 q/k/v biases (frozen, no LoRA)
                yield f"{prefix}.{hf}.bias", tuple(state[f"{key}.bias"].shape), plain(f"{key}.bias")
        if cfg.n_experts:
            moe, mp = f"layers.{i}.moe", f"{prefix}.block_sparse_moe"
            router = state[f"{moe}.router_kernel"]
            yield (f"{mp}.gate.weight", tuple(reversed(router.shape)),
                   lambda router=router: router.to(torch.float32).T)
            for stem, hf_w in _HF_EXPERTS:
                shape = tuple(reversed(kernel_shape(f"{moe}.{stem}")))
                for e in range(cfg.n_experts):
                    yield f"{mp}.experts.{e}.{hf_w}.weight", shape, expert(f"{moe}.{stem}", e)
    yield "model.norm.weight", tuple(state["final_norm.scale"].shape), plain("final_norm.scale")
    if not cfg.tie_embeddings:
        head = state["lm_head.kernel"]
        yield "lm_head.weight", tuple(reversed(head.shape)), lambda: head.to(torch.float32).T


def export_merged_checkpoint(
    cfg,
    state: Mapping[str, torch.Tensor],
    out_dir: Path | str,
    *,
    dtype: torch.dtype = torch.float32,
    max_shard_bytes: int | None = None,
) -> Path:
    """Write a full HF checkpoint with LoRA deltas merged into the base
    (``W_eff = W + (alpha/r)·A·B`` in f32), loadable by ``transformers``.

    By default one f32 ``model.safetensors``, as the reference writes.
    ``dtype`` casts every tensor after the merge; ``max_shard_bytes`` splits
    the tensors, in order, into ``model-0000k-of-0000n.safetensors`` shards
    of at most that size (a larger tensor gets a shard of its own) with a
    ``model.safetensors.index.json``, the layout of the hub's checkpoints."""
    config = hf_config(cfg, dtype)  # raises before any file is written
    out_dir = Path(out_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = list(_merged_entries(cfg, state))
    itemsize = torch.empty((), dtype=dtype).element_size()
    shards: list[list] = [[]]
    size = 0
    for entry in entries:
        nbytes = itemsize * torch.Size(entry[1]).numel()
        if max_shard_bytes and shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(entry)
        size += nbytes
    names = (["model.safetensors"] if len(shards) == 1 and not max_shard_bytes else
             [f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors" for k in range(len(shards))])
    total = 0
    weight_map = {}
    for name, shard in zip(names, shards):
        specs = [(hf, dtype, shape) for hf, shape, _ in shard]
        total += _write(out_dir / name, specs,
                        ((hf, produce().to(dtype)) for hf, _, produce in shard))
        weight_map.update({hf: name for hf, _, _ in shard})
    if max_shard_bytes:
        tensor_bytes = sum(itemsize * torch.Size(s).numel() for _, s, _ in entries)
        index = {"metadata": {"total_size": tensor_bytes}, "weight_map": weight_map}
        (out_dir / INDEX_FILENAME).write_text(json.dumps(index, indent=2))
    (out_dir / "config.json").write_text(json.dumps(config, indent=2))
    logger.info("wrote merged HF checkpoint (%d tensors, %d files, %.2f GB) -> %s",
                len(entries), len(names), total / 1e9, out_dir)
    return out_dir
