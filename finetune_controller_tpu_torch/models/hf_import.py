"""Import pretrained HuggingFace Llama-family checkpoints into the port's
state dict (counterpart of the reference's ``models/hf_import.py:40-195``).

A local HF checkpoint directory (``*.safetensors`` shards, read through
``models/safetensors_io.py``, or ``pytorch_model*.bin``) maps onto the
names of :class:`~.llama.LlamaForCausalLM`'s ``state_dict()``, for the
dense Llama family (TinyLlama, Llama-3, Mistral), Qwen-2 (q/k/v biases) and
Gemma (offset-form norms, which HF stores as the port does).

Layout: HF ``nn.Linear`` stores ``(out_features, in_features)``; the port
computes ``x @ W`` with ``(in, out)`` kernels (``models/convert.py``), so
every projection is transposed.  RoPE conventions match, so no head
permutation is needed.

* :func:`load_llama_params` returns the state dict (every tensor cast to
  ``dtype``, on ``device``), as the reference returns its tree;
* :func:`load_pretrained_` streams the checkpoint into a built model in
  place: each tensor goes to the model's device as it is read, is
  transposed there and copied into its parameter, cast to the parameter's
  storage dtype.  No host copy of the whole checkpoint is made.

Both raise the reference's errors for a checkpoint that does not fit the
config.  Mixtral experts and LLaVA checkpoints wait for ROADMAP Queue A
item 5.  No network access happens here: the directory must be on disk.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Iterable, Iterator

import torch

from .safetensors_io import checkpoint_files, iter_dir_tensors

logger = logging.getLogger(__name__)

#: HF layer tensor -> (port leaf under ``layers.{i}.``, transposed), in the
#: order the reference pops them (its first missing one is the KeyError)
_NORMS = (("input_layernorm.weight", "attn_norm.scale"),
          ("post_attention_layernorm.weight", "mlp_norm.scale"))
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _layer_map(cfg) -> dict[str, tuple[str, bool]]:
    out = {hf: (leaf, False) for hf, leaf in _NORMS}
    out.update({f"self_attn.{p}.weight": (f"attn.{p}.kernel", True) for p in _ATTN})
    if cfg.attention_qkv_bias:
        # Qwen-2 family: q/k/v carry biases (o_proj does not)
        out.update({f"self_attn.{p}.bias": (f"attn.{p}.bias", False) for p in _ATTN[:3]})
    out.update({f"mlp.{p}.weight": (f"mlp.{p}.kernel", True) for p in _MLP})
    return out


def _refuse_unported(cfg) -> None:
    if getattr(cfg, "n_experts", 0):
        raise NotImplementedError(
            "importing Mixtral expert checkpoints is not ported yet (ROADMAP Queue A item 5)")


def _iter_checkpoint_tensors(ckpt_dir: Path) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield (hf_name, CPU tensor) from safetensors shards or a torch .bin
    file; safetensors tensors view the files' memory maps."""
    if checkpoint_files(ckpt_dir):
        yield from iter_dir_tensors(ckpt_dir)
        return
    bin_files = sorted(ckpt_dir.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(
            f"no *.safetensors or pytorch_model*.bin under {ckpt_dir}"
        )
    for f in bin_files:
        state = torch.load(str(f), map_location="cpu", weights_only=True)
        yield from state.items()


def _strip(name: str) -> str:
    return name.removeprefix("model.")


def _map_llama_tensors(pairs: Iterable[tuple[str, torch.Tensor]], cfg
                       ) -> Iterator[tuple[str, torch.Tensor, bool]]:
    """Map stripped ``(hf_name, tensor)`` pairs onto the port's names:
    yields ``(state_key, tensor, transpose)`` as the pairs arrive, then
    checks what arrived with the reference's rules and messages (out of
    range layers at once, the rest once the checkpoint is read)."""
    L = cfg.n_layers
    layer_map = _layer_map(cfg)
    seen: list[set[str]] = [set() for _ in range(L)]
    extra: list[list[str]] = [[] for _ in range(L)]
    top: set[str] = set()
    unexpected: list[str] = []
    for key, tensor in pairs:
        if "rotary_emb.inv_freq" in key:
            # non-persistent RoPE buffer serialized by transformers < 4.32
            # (Llama-2-era .bin checkpoints); recomputed from config here
            continue
        if key == "embed_tokens.weight":
            top.add("embedding")
            yield "embed_tokens.embedding", tensor, False
        elif key == "norm.weight":
            top.add("final_norm")
            yield "final_norm.scale", tensor, False
        elif key == "lm_head.weight":
            top.add("lm_head")
            if not cfg.tie_embeddings:
                yield "lm_head.kernel", tensor, True
        elif key.startswith("layers."):
            _, idx_s, rest = key.split(".", 2)
            idx = int(idx_s)
            if idx >= L:
                raise ValueError(
                    f"checkpoint layer {idx} out of range for n_layers={L}"
                )
            seen[idx].add(rest)
            if rest in layer_map:
                leaf, transpose = layer_map[rest]
                yield f"layers.{idx}.{leaf}", tensor, transpose
            else:
                extra[idx].append(rest)
        else:
            unexpected.append(key)
    if unexpected:
        raise ValueError(f"unexpected checkpoint tensors: {unexpected[:5]}")
    missing = [i for i, names in enumerate(seen) if not names]
    if missing:
        raise ValueError(f"checkpoint has no tensors for layers {missing[:5]}")
    for idx, names in enumerate(seen):
        for hf in layer_map:
            if hf not in names:
                raise KeyError(hf)
        if extra[idx]:
            raise ValueError(f"layer {idx}: unmapped tensors {sorted(extra[idx])[:5]}")
    if "embedding" not in top or "final_norm" not in top:
        raise ValueError("checkpoint missing embed_tokens/norm weights")
    if cfg.tie_embeddings:
        if "lm_head" in top:
            logger.info("tie_embeddings=True: ignoring separate lm_head weight")
    elif "lm_head" not in top:
        raise ValueError(
            "checkpoint has no lm_head.weight but cfg.tie_embeddings=False"
        )


def load_llama_params(ckpt_dir: Path | str, cfg, dtype: Any = None,
                      device=None) -> dict[str, torch.Tensor]:
    """The port's state dict (base entries only) from an HF checkpoint dir:
    each tensor moved to ``device`` (the host by default), transposed there
    where HF's layout differs, and cast to ``dtype`` (``cfg.param_dtype``
    by default).  Raises on missing or unexpected tensors, so an
    architecture/config mismatch fails at load."""
    _refuse_unported(cfg)
    ckpt_dir = Path(ckpt_dir).expanduser()
    dtype = dtype or cfg.param_dtype
    device = torch.device("cpu") if device is None else torch.device(device)
    state: dict[str, torch.Tensor] = {}
    pairs = ((_strip(n), t) for n, t in _iter_checkpoint_tensors(ckpt_dir))
    for key, tensor, transpose in _map_llama_tensors(pairs, cfg):
        tensor = tensor.to(device)
        state[key] = (tensor.T if transpose else tensor).to(dtype).contiguous()
    n_params = sum(t.numel() for t in state.values())
    logger.info("loaded %d tensors (%.1fM params) from %s", len(state), n_params / 1e6, ckpt_dir)
    return state


@torch.no_grad()
def load_pretrained_(model, ckpt_dir: Path | str):
    """Copy an HF checkpoint into ``model``'s base parameters in place (the
    LoRA leaves and tenant stacks are left as they are).  Each tensor is
    moved to the parameter's device, transposed there and cast to the
    parameter's dtype by ``copy_``; shapes are checked tensor by tensor and
    every base parameter must be filled.  Returns ``model``."""
    cfg = model.cfg
    _refuse_unported(cfg)
    ckpt_dir = Path(ckpt_dir).expanduser()
    params = dict(model.named_parameters())
    filled: set[str] = set()
    pairs = ((_strip(n), t) for n, t in _iter_checkpoint_tensors(ckpt_dir))
    for key, tensor, transpose in _map_llama_tensors(pairs, cfg):
        param = params[key]
        src = tensor.to(param.device)
        src = src.T if transpose else src
        if src.shape != param.shape:
            raise ValueError(f"checkpoint tensor for {key} has shape {tuple(src.shape)}, "
                             f"the model's is {tuple(param.shape)}")
        param.copy_(src)
        filled.add(key)
    base = [k for k in params if not k.endswith((".lora_a", ".lora_b"))]
    unfilled = [k for k in base if k not in filled]
    if unfilled:
        raise ValueError(f"checkpoint left model parameters unfilled: {unfilled[:5]}")
    logger.info("loaded %d pretrained tensors into the model from %s", len(filled), ckpt_dir)
    return model


def load_llava_params(ckpt_dir: Path | str, cfg) -> dict[str, torch.Tensor]:
    """LLaVA (CLIP tower + projector + Llama) import: not ported yet."""
    raise NotImplementedError(
        "importing LLaVA checkpoints is not ported yet (ROADMAP Queue A item 5)")
