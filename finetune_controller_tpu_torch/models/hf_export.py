"""Export trained artifacts in HuggingFace-consumable formats (counterpart of
the reference's ``models/hf_export.py:28-299``).

The other half of ``hf_import.py``: after a fine-tune the trainer writes
either a **PEFT adapter** directory (``adapter_model.safetensors`` +
``adapter_config.json``, loadable with ``peft.PeftModel``) or a **merged
full checkpoint** (``model.safetensors`` + ``config.json``, loadable with
``transformers``), for dense Llama, Qwen-2 and Gemma.  Both read the port's
state dict (``LlamaForCausalLM.state_dict()`` names, tensors on any
device); every key of ``config.json`` and ``adapter_config.json`` is the
reference's.

Files are written through ``models/safetensors_io.StreamWriter``: the
header is computed from the config's shapes and each tensor is produced,
moved to the host and written one at a time, so an 8B merged export never
holds the 32 GB f32 dict the reference builds.  Merging uses
``models/convert.merge_kernel``, as the serving loader does.  MoE, int4
bases and the multimodal projector wait for ROADMAP Queue A item 5.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Iterator, Mapping

import torch

from .convert import merge_kernel
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


def _refuse_unported(cfg, what: str) -> None:
    if getattr(cfg, "n_experts", 0):
        raise NotImplementedError(
            f"{what} of MoE configs is not ported yet (ROADMAP Queue A item 5)")
    if getattr(cfg, "quantize_base", False):
        raise NotImplementedError(
            f"{what} of int4 QLoRA bases is not ported yet (ROADMAP Queue A item 5)")


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


def export_mm_projector(projector, out_dir: Path | str) -> Path:
    """The trained LLaVA projector beside the adapter: not ported yet."""
    raise NotImplementedError(
        "exporting the multimodal projector is not ported yet (ROADMAP Queue A item 5)")


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
            w = state[f"{key}.kernel"].to(torch.float32)              # (in, out)
            if f"{key}.lora_a" in state:
                w = merge_kernel(w, state[f"{key}.lora_a"], state[f"{key}.lora_b"], scale)
            return w.T
        return produce

    emb = state["embed_tokens.embedding"]
    yield "model.embed_tokens.weight", tuple(emb.shape), plain("embed_tokens.embedding")
    for i in range(cfg.n_layers):
        prefix = f"model.layers.{i}"
        for hf, leaf in (("input_layernorm", "attn_norm"),
                         ("post_attention_layernorm", "mlp_norm")):
            key = f"layers.{i}.{leaf}.scale"
            yield f"{prefix}.{hf}.weight", tuple(state[key].shape), plain(key)
        for proj, hf in _HF_MODULE.items():
            key = f"layers.{i}.{_GROUP[proj]}.{proj}"
            yield (f"{prefix}.{hf}.weight", tuple(reversed(state[f"{key}.kernel"].shape)),
                   kernel(key))
            if f"{key}.bias" in state:  # Qwen-2 q/k/v biases (frozen, no LoRA)
                yield f"{prefix}.{hf}.bias", tuple(state[f"{key}.bias"].shape), plain(f"{key}.bias")
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
    _refuse_unported(cfg, "merged export")
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
