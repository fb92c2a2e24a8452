"""Import pretrained HuggingFace Llama-family checkpoints into the port's
state dict (counterpart of the reference's ``models/hf_import.py:40-195``).

A local HF checkpoint directory (``*.safetensors`` shards, read through
``models/safetensors_io.py``, or ``pytorch_model*.bin``) maps onto the
names of :class:`~.llama.LlamaForCausalLM`'s ``state_dict()``, for the
dense Llama family (TinyLlama, Llama-3, Mistral), Qwen-2 (q/k/v biases),
Gemma (offset-form norms, which HF stores as the port does) and Mixtral
(``block_sparse_moe.experts.{e}.w1/w2/w3`` stacked into the ``(E, in, out)``
expert kernels gate/down/up, ``block_sparse_moe.gate`` the router;
reference ``hf_import.py:136-150``).

Layout: HF ``nn.Linear`` stores ``(out_features, in_features)``; the port
computes ``x @ W`` with ``(in, out)`` kernels (``models/convert.py``), so
every projection is transposed.  RoPE conventions match, so no head
permutation is needed.

* :func:`load_llama_params` returns the state dict (every tensor cast to
  ``dtype``, on ``device``), as the reference returns its tree;
* :func:`load_pretrained_` streams the checkpoint into a built model in
  place: each tensor goes to the model's device as it is read, is
  transposed there and copied into its parameter, cast to the parameter's
  storage dtype; a kernel the model stores as int4 (``quantize_base``) is
  quantized there instead (``models/quant.py``, one matrix or one expert
  at a time; the reference's ``_adapt_loaded_params``).  No host copy of
  the whole checkpoint is made.

Both raise the reference's errors for a checkpoint that does not fit the
config.  LLaVA checkpoints wait for ROADMAP Queue A item 5.  No network
access happens here: the directory must be on disk.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Iterable, Iterator

import torch

from .quant import quantize_int4
from .safetensors_io import checkpoint_files, iter_dir_tensors

logger = logging.getLogger(__name__)

#: HF layer tensor -> (port leaf under ``layers.{i}.``, transposed), in the
#: order the reference pops them (its first missing one is the KeyError)
_NORMS = (("input_layernorm.weight", "attn_norm.scale"),
          ("post_attention_layernorm.weight", "mlp_norm.scale"))
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


#: Mixtral's per-expert weights -> the port's stacked expert kernels
_EXPERTS = (("w1", "experts_gate"), ("w2", "experts_down"), ("w3", "experts_up"))


def _layer_map(cfg) -> dict[str, tuple[str, bool, int | None]]:
    """HF layer tensor -> (port leaf, transposed, expert index or None)."""
    out = {hf: (leaf, False, None) for hf, leaf in _NORMS}
    out.update({f"self_attn.{p}.weight": (f"attn.{p}.kernel", True, None) for p in _ATTN})
    if cfg.attention_qkv_bias:
        # Qwen-2 family: q/k/v carry biases (o_proj does not)
        out.update({f"self_attn.{p}.bias": (f"attn.{p}.bias", False, None) for p in _ATTN[:3]})
    if getattr(cfg, "n_experts", 0):
        for e in range(cfg.n_experts):
            out.update({f"block_sparse_moe.experts.{e}.{w}.weight": (f"moe.{leaf}", True, e)
                        for w, leaf in _EXPERTS})
        out["block_sparse_moe.gate.weight"] = ("moe.router_kernel", True, None)
    else:
        out.update({f"mlp.{p}.weight": (f"mlp.{p}.kernel", True, None) for p in _MLP})
    return out


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
                       ) -> Iterator[tuple[str, int | None, torch.Tensor, bool]]:
    """Map stripped ``(hf_name, tensor)`` pairs onto the port's names:
    yields ``(state_key, expert, tensor, transpose)`` as the pairs arrive
    (``expert`` indexes the leading axis of a stacked expert kernel, else
    ``None``), then
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
            yield "embed_tokens.embedding", None, tensor, False
        elif key == "norm.weight":
            top.add("final_norm")
            yield "final_norm.scale", None, tensor, False
        elif key == "lm_head.weight":
            top.add("lm_head")
            if not cfg.tie_embeddings:
                yield "lm_head.kernel", None, tensor, True
        elif key.startswith("layers."):
            _, idx_s, rest = key.split(".", 2)
            idx = int(idx_s)
            if idx >= L:
                raise ValueError(
                    f"checkpoint layer {idx} out of range for n_layers={L}"
                )
            seen[idx].add(rest)
            if rest in layer_map:
                leaf, transpose, expert = layer_map[rest]
                yield f"layers.{idx}.{leaf}", expert, tensor, transpose
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
    architecture/config mismatch fails at load.  Mixtral experts come back
    stacked, ``(E, in, out)`` per kernel."""
    ckpt_dir = Path(ckpt_dir).expanduser()
    dtype = dtype or cfg.param_dtype
    device = torch.device("cpu") if device is None else torch.device(device)
    state: dict[str, torch.Tensor] = {}
    experts: dict[str, dict[int, torch.Tensor]] = {}
    pairs = ((_strip(n), t) for n, t in _iter_checkpoint_tensors(ckpt_dir))
    for key, expert, tensor, transpose in _map_llama_tensors(pairs, cfg):
        tensor = tensor.to(device)
        tensor = (tensor.T if transpose else tensor).to(dtype).contiguous()
        if expert is None:
            state[key] = tensor
        else:
            experts.setdefault(key, {})[expert] = tensor
    for key, stack in experts.items():
        state[key] = torch.stack([stack[e] for e in range(len(stack))])
    n_params = sum(t.numel() for t in state.values())
    logger.info("loaded %d tensors (%.1fM params) from %s", len(state), n_params / 1e6, ckpt_dir)
    return state


@torch.no_grad()
def load_pretrained_(model, ckpt_dir: Path | str):
    """Copy an HF checkpoint into ``model``'s base parameters in place (the
    LoRA leaves and tenant stacks are left as they are).  Each tensor is
    moved to the parameter's device, transposed there and cast to the
    parameter's dtype by ``copy_``; a kernel the model stores as int4 is
    quantized there into its ``_packed``/``_scales`` buffers (an expert
    into its slice of the stack).  Shapes are checked tensor by tensor
    and every base parameter and int4 kernel must be filled.  Returns
    ``model``."""
    cfg = model.cfg
    ckpt_dir = Path(ckpt_dir).expanduser()
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    filled: set[tuple[str, int | None]] = set()
    pairs = ((_strip(n), t) for n, t in _iter_checkpoint_tensors(ckpt_dir))
    for key, expert, tensor, transpose in _map_llama_tensors(pairs, cfg):
        quantized = key not in params and f"{key}_packed" in buffers
        if quantized:
            packed, scales = buffers[f"{key}_packed"], buffers[f"{key}_scales"]
            want = packed.shape[:-2] + (packed.shape[-2] * 2, packed.shape[-1])
            device = packed.device
        else:
            want, device = params[key].shape, params[key].device
        if expert is not None:
            want = want[1:]
        src = tensor.to(device)
        src = src.T if transpose else src
        if src.shape != want:
            raise ValueError(f"checkpoint tensor for {key} has shape {tuple(src.shape)}, "
                             f"the model's is {tuple(want)}")
        if quantized:
            q, s = quantize_int4(src, cfg.quant_block)
            packed_at, scales_at = ((packed, scales) if expert is None
                                    else (packed[expert], scales[expert]))
            packed_at.copy_(q)
            scales_at.copy_(s)
        else:
            (params[key] if expert is None else params[key][expert]).copy_(src)
        filled.add((key, expert))
    stacked = getattr(cfg, "n_experts", 0)
    base = [k for k in params if not k.endswith((".lora_a", ".lora_b"))]
    base += [k.removesuffix("_packed") for k in buffers if k.endswith("_packed")]
    unfilled = [k for k in base
                if not all((k, e) in filled for e in
                           (range(stacked) if ".moe.experts_" in k else (None,)))]
    if unfilled:
        raise ValueError(f"checkpoint left model parameters unfilled: {unfilled[:5]}")
    logger.info("loaded %d pretrained tensors into the model from %s", len(filled), ckpt_dir)
    return model


def load_llava_params(ckpt_dir: Path | str, cfg) -> dict[str, torch.Tensor]:
    """LLaVA (CLIP tower + projector + Llama) import: not ported yet."""
    raise NotImplementedError(
        "importing LLaVA checkpoints is not ported yet (ROADMAP Queue A item 5)")
