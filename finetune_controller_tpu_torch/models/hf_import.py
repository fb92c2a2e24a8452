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

A LLaVA checkpoint (``LlavaForConditionalGeneration``'s layout,
reference ``hf_import.py:198-330``) maps its ``language_model.*`` as above,
``vision_tower.vision_model.*`` onto the CLIP tower of
``models/multimodal.py`` and ``multi_modal_projector.linear_{1,2}`` onto
``projector_fc{1,2}`` (an outer ``model.`` of transformers >= 4.52 is
dropped first).  The port keeps HF's ``OIHW`` patch convolution and
transposes the ``(out, in)`` linear weights; the layers and the post norm
that the selected feature layer never runs are skipped.
:func:`load_llava_params` returns the state dict, and
:func:`load_pretrained_` streams a LLaVA checkpoint into a built
``LlavaForCausalLM`` the same way.

Both raise the reference's errors for a checkpoint that does not fit the
config.  No network access happens here: the directory must be on disk.
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


#: one mapped tensor: (state key, expert index or None, tensor, transposed)
_Mapped = tuple[str, "int | None", torch.Tensor, bool]


class _TextMapper:
    """Maps stripped ``(hf_name, tensor)`` pairs of a Llama-family decoder
    onto the port's names one at a time (:meth:`map`), then checks what
    arrived with the reference's rules and messages (:meth:`check`; out of
    range layers raise at once)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.layer_map = _layer_map(cfg)
        self.seen: list[set[str]] = [set() for _ in range(cfg.n_layers)]
        self.extra: list[list[str]] = [[] for _ in range(cfg.n_layers)]
        self.top: set[str] = set()
        self.unexpected: list[str] = []

    def map(self, key: str, tensor: torch.Tensor) -> Iterator[_Mapped]:
        if "rotary_emb.inv_freq" in key:
            # non-persistent RoPE buffer serialized by transformers < 4.32
            # (Llama-2-era .bin checkpoints); recomputed from config here
            return
        if key == "embed_tokens.weight":
            self.top.add("embedding")
            yield "embed_tokens.embedding", None, tensor, False
        elif key == "norm.weight":
            self.top.add("final_norm")
            yield "final_norm.scale", None, tensor, False
        elif key == "lm_head.weight":
            self.top.add("lm_head")
            if not self.cfg.tie_embeddings:
                yield "lm_head.kernel", None, tensor, True
        elif key.startswith("layers."):
            _, idx_s, rest = key.split(".", 2)
            idx = int(idx_s)
            if idx >= self.cfg.n_layers:
                raise ValueError(
                    f"checkpoint layer {idx} out of range for n_layers={self.cfg.n_layers}"
                )
            self.seen[idx].add(rest)
            if rest in self.layer_map:
                leaf, transpose, expert = self.layer_map[rest]
                yield f"layers.{idx}.{leaf}", expert, tensor, transpose
            else:
                self.extra[idx].append(rest)
        else:
            self.unexpected.append(key)

    def check(self) -> None:
        if self.unexpected:
            raise ValueError(f"unexpected checkpoint tensors: {self.unexpected[:5]}")
        missing = [i for i, names in enumerate(self.seen) if not names]
        if missing:
            raise ValueError(f"checkpoint has no tensors for layers {missing[:5]}")
        for idx, names in enumerate(self.seen):
            for hf in self.layer_map:
                if hf not in names:
                    raise KeyError(hf)
            if self.extra[idx]:
                raise ValueError(f"layer {idx}: unmapped tensors {sorted(self.extra[idx])[:5]}")
        if "embedding" not in self.top or "final_norm" not in self.top:
            raise ValueError("checkpoint missing embed_tokens/norm weights")
        if self.cfg.tie_embeddings:
            if "lm_head" in self.top:
                logger.info("tie_embeddings=True: ignoring separate lm_head weight")
        elif "lm_head" not in self.top:
            raise ValueError(
                "checkpoint has no lm_head.weight but cfg.tie_embeddings=False"
            )


def _vision_map(vcfg) -> dict[str, tuple[str, bool, tuple[int, ...] | None]]:
    """CLIP vision-model tensor (``vision_tower.vision_model.`` stripped) ->
    (port key, transposed, shape to view it as or None) for the tensors the
    selected feature layer runs (the reference's ``_map_vision_tensors``).
    HF's ``OIHW`` patch convolution is the port's layout; linear weights
    are ``(out, in)`` and transposed."""
    d = vcfg.d_model
    vt = "vision_tower"
    out = {"embeddings.patch_embedding.weight": (f"{vt}.patch_embed.kernel", False, None)}
    if vcfg.patch_bias:
        out["embeddings.patch_embedding.bias"] = (f"{vt}.patch_embed.bias", False, None)
    out["embeddings.position_embedding.weight"] = (
        f"{vt}.pos_embed", False, (1, vcfg.n_patches + vcfg.cls_token, d))
    if vcfg.cls_token:
        out["embeddings.class_embedding"] = (f"{vt}.cls", False, (1, 1, d))
    if vcfg.pre_norm:
        # (the "pre_layrnorm" typo is transformers' own attribute name)
        out["pre_layrnorm.weight"] = (f"{vt}.pre_norm.scale", False, None)
        out["pre_layrnorm.bias"] = (f"{vt}.pre_norm.bias", False, None)
    for i in range(vcfg.n_run):
        # in the reference's order: its first missing tensor names the error
        hf, port = f"encoder.layers.{i}.", f"{vt}.blocks.{i}."
        out[f"{hf}layer_norm1.weight"] = (f"{port}ln1.scale", False, None)
        out[f"{hf}layer_norm1.bias"] = (f"{port}ln1.bias", False, None)
        for nm, leaf in (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value"),
                         ("out_proj", "out")):
            out[f"{hf}self_attn.{nm}.weight"] = (f"{port}attn.{leaf}.kernel", True, None)
            out[f"{hf}self_attn.{nm}.bias"] = (f"{port}attn.{leaf}.bias", False, None)
        out[f"{hf}layer_norm2.weight"] = (f"{port}ln2.scale", False, None)
        out[f"{hf}layer_norm2.bias"] = (f"{port}ln2.bias", False, None)
        for fc in ("fc1", "fc2"):
            out[f"{hf}mlp.{fc}.weight"] = (f"{port}{fc}.kernel", True, None)
            out[f"{hf}mlp.{fc}.bias"] = (f"{port}{fc}.bias", False, None)
    if vcfg.feature_layer == 0:
        out["post_layernorm.weight"] = (f"{vt}.final_norm.scale", False, None)
        out["post_layernorm.bias"] = (f"{vt}.final_norm.bias", False, None)
    return out


#: HF's projector tensors -> (the port's key, transposed)
_PROJECTOR = {"linear_1.weight": ("projector_fc1.kernel", True),
              "linear_1.bias": ("projector_fc1.bias", False),
              "linear_2.weight": ("projector_fc2.kernel", True),
              "linear_2.bias": ("projector_fc2.bias", False)}


def _map_llava_tensors(pairs: Iterable[tuple[str, torch.Tensor]], cfg) -> Iterator[_Mapped]:
    """:func:`_map_tensors` for a LLaVA checkpoint: the decoder under
    ``language_model.``, the CLIP tower under ``vision_tower.vision_model.``
    and the projector under ``multi_modal_projector.``; the checks and
    messages are the reference's ``load_llava_params``."""
    vcfg = cfg.vision
    text = _TextMapper(cfg.text)
    vision = _vision_map(vcfg)
    vision_left = set(vision)
    projector_left = set(_PROJECTOR)
    unexpected: list[str] = []
    leftover: list[str] = []
    extra_projector: list[str] = []
    # tensors the selected feature layer never touches
    skippable = tuple(f"encoder.layers.{i}." for i in range(vcfg.n_run, vcfg.n_layers)) + (
        ("post_layernorm.",) if vcfg.feature_layer != 0 else ())
    for name, tensor in pairs:
        # transformers >= 4.52 nests the text model under model.*
        name = name.removeprefix("model.")
        if name.startswith("language_model."):
            yield from text.map(_strip(name.removeprefix("language_model.")), tensor)
        elif name.startswith("vision_tower.vision_model."):
            rest = name.removeprefix("vision_tower.vision_model.")
            if rest in vision:
                key, transpose, shape = vision[rest]
                vision_left.discard(rest)
                yield key, None, tensor if shape is None else tensor.reshape(shape), transpose
            elif not rest.startswith(skippable):
                leftover.append(rest)
        elif name.startswith("multi_modal_projector."):
            rest = name.removeprefix("multi_modal_projector.")
            if rest in _PROJECTOR:
                projector_left.discard(rest)
                yield _PROJECTOR[rest][0], None, tensor, _PROJECTOR[rest][1]
            else:
                extra_projector.append(rest)
        else:
            unexpected.append(name)
    if unexpected:
        raise ValueError(f"unexpected checkpoint tensors: {unexpected[:5]}")
    text.check()
    if vision_left:
        first = next(k for k in vision if k in vision_left)
        raise ValueError(
            f"vision tower missing tensor {first!r} — config/checkpoint mismatch"
        )
    if leftover:
        raise ValueError(f"unmapped vision tensors: {sorted(leftover)[:5]}")
    if projector_left:
        first = next(k for k in _PROJECTOR if k in projector_left)
        raise ValueError(f"projector missing tensor {first!r}")
    if extra_projector:
        raise ValueError(f"unmapped projector tensors: {sorted(extra_projector)[:5]}")


def _map_tensors(ckpt_dir: Path, cfg) -> Iterator[_Mapped]:
    """The checkpoint's tensors mapped onto the port's names for ``cfg``
    (a LLaVA layout for a multimodal config): yields ``(state_key, expert,
    tensor, transpose)`` as they are read (``expert`` indexes the leading
    axis of a stacked expert kernel, else ``None``), then checks what
    arrived with the reference's rules and messages."""
    pairs = _iter_checkpoint_tensors(ckpt_dir)
    if getattr(cfg, "vision", None) is not None:
        yield from _map_llava_tensors(pairs, cfg)
        return
    mapper = _TextMapper(cfg)
    for name, tensor in pairs:
        yield from mapper.map(_strip(name), tensor)
    mapper.check()


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
    for key, expert, tensor, transpose in _map_tensors(ckpt_dir, cfg):
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
    for key, expert, tensor, transpose in _map_tensors(ckpt_dir, cfg):
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
            q, s = quantize_int4(src, model.text_cfg.quant_block)
            packed_at, scales_at = ((packed, scales) if expert is None
                                    else (packed[expert], scales[expert]))
            packed_at.copy_(q)
            scales_at.copy_(s)
        else:
            (params[key] if expert is None else params[key][expert]).copy_(src)
        filled.add((key, expert))
    stacked = cfg.n_experts
    base = [k for k in params if not k.endswith((".lora_a", ".lora_b"))]
    base += [k.removesuffix("_packed") for k in buffers if k.endswith("_packed")]
    unfilled = [k for k in base
                if not all((k, e) in filled for e in
                           (range(stacked) if ".moe.experts_" in k else (None,)))]
    if unfilled:
        raise ValueError(f"checkpoint left model parameters unfilled: {unfilled[:5]}")
    logger.info("loaded %d pretrained tensors into the model from %s", len(filled), ckpt_dir)
    return model


def load_llava_params(ckpt_dir: Path | str, cfg, dtype: Any = None,
                      device=None) -> dict[str, torch.Tensor]:
    """``LlavaForCausalLM``'s state dict (base entries: the decoder, the
    tower and the projector) from an HF LLaVA checkpoint dir
    (``LlavaForConditionalGeneration``'s layout), every tensor cast to
    ``dtype`` (``cfg.text.param_dtype`` by default) on ``device``."""
    return load_llama_params(ckpt_dir, cfg, dtype or cfg.text.param_dtype, device)
