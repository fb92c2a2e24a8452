"""LLaVA-style multimodal model: ViT encoder → projector → Llama decoder
(counterpart of the reference's ``models/multimodal.py``).

A vision transformer encodes the image into patch embeddings, a 2-layer MLP
projects them into the decoder's embedding space, and the projected patch
tokens are prepended to the text embeddings, so the decoder attends to the
image as a prefix.  The combined sequence is ``n_patches + text_len``;
the logits cover the text positions only.

``ViTConfig``, ``LlavaConfig`` (with the duck-type surface the trainer reads,
and ``replace`` routing the decoder's keys into ``text``) and
``MM_PRESETS`` are copied field for field with torch dtypes.  Parameter
names follow the flax tree where torch allows (``models/convert.py`` maps
the rest):

* ``vision_tower.patch_embed.kernel`` is the stride-``patch_size``
  convolution in torch's ``OIHW`` layout (flax stores ``HWIO``), with a
  ``bias`` only when ``patch_bias``;
* each block's attention holds ``query``/``key``/``value``/``out`` as
  ``(d, d)`` ``(in, out)`` kernels with biases (flax's
  ``MultiHeadDotProductAttention`` stores ``(d, H, hd)`` and ``(H, hd, d)``);
* ``vision_tower.blocks.{i}`` are flax's ``block_{i}``.

The tower's attention is bidirectional multi-head attention in plain torch
ops (the reference computes it in XLA, outside any Pallas kernel), its
softmax in f32.  With ``feature_layer = -k`` only ``n_layers - k + 1``
blocks are built and run and there is no final norm (LLaVA-1.5 takes
CLIP's ``hidden_states[-2]``); a class token rides through attention and is
dropped from the output.  The decoder is :class:`~.llama.LlamaForCausalLM`
itself (this model subclasses it), run over the image prefix and the text
with explicit positions; its LM head never carries LoRA.

The tower and the projector run inside ``torch.profiler`` ranges named
``vision_tower`` and ``mm_projector``, so a trace splits the step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .llama import DenseKV, LlamaConfig, LlamaForCausalLM
from .lora import LoRAConfig, LoRADense


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 336
    patch_size: int = 14
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    #: prepend a learned class token (CLIP); dropped from the output
    cls_token: bool = False
    #: LayerNorm right after the embeddings (CLIP's pre_layrnorm)
    pre_norm: bool = False
    #: patch convolution bias (CLIP has none)
    patch_bias: bool = True
    #: MLP activation: "gelu" (exact) | "quick_gelu" (x·σ(1.702x))
    act: str = "gelu"
    #: the hidden state the projector reads: 0 = every layer and the final
    #: norm; -k = CLIP's hidden_states[-k] (no final norm)
    feature_layer: int = 0
    ln_eps: float = 1e-5

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_run(self) -> int:
        """The blocks the selected feature layer runs (and the only ones
        built)."""
        n_run = self.n_layers if self.feature_layer == 0 else self.n_layers + self.feature_layer + 1
        if not 0 < n_run <= self.n_layers:
            raise ValueError(
                f"feature_layer {self.feature_layer} out of range for {self.n_layers} layers"
            )
        return n_run

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    vision: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    projector_hidden: int = 4096

    # the trainer's duck-type surface (mirrors LlamaConfig)
    @property
    def vocab_size(self) -> int:
        return self.text.vocab_size

    @property
    def lora(self) -> LoRAConfig:
        return self.text.lora

    @property
    def n_experts(self) -> int:
        return self.text.n_experts

    @property
    def router_aux_weight(self) -> float:
        return self.text.router_aux_weight

    @property
    def attention_impl(self) -> str:
        return self.text.attention_impl

    @property
    def image_size(self) -> int:
        return self.vision.image_size

    @property
    def max_seq_len(self) -> int:
        """The decoder's position budget, shared by the image prefix
        (``n_patches``) and the text."""
        return self.text.max_seq_len

    # what the port's trainer and loader read besides
    @property
    def dtype(self):
        return self.text.dtype

    @property
    def param_dtype(self):
        return self.text.param_dtype

    @property
    def quantize_base(self) -> bool:
        return self.text.quantize_base

    def replace(self, **kw) -> "LlavaConfig":
        # route decoder-level overrides (lora=..., dtype=...) into the text config
        text_keys = {f.name for f in dataclasses.fields(LlamaConfig)}
        text_kw = {k: v for k, v in kw.items() if k in text_keys}
        top_kw = {k: v for k, v in kw.items() if k not in text_keys}
        cfg = self
        if text_kw:
            cfg = dataclasses.replace(cfg, text=cfg.text.replace(**text_kw))
        if top_kw:
            cfg = dataclasses.replace(cfg, **top_kw)
        return cfg


class LayerNorm(nn.Module):
    """flax's ``LayerNorm``: statistics and scaling in f32, the result in
    the compute dtype; ``scale`` and ``bias`` parameters."""

    def __init__(self, dim: int, eps: float, dtype, param_dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), x.shape[-1:], self.scale.to(torch.float32),
                            self.bias.to(torch.float32), self.eps).to(self.dtype)


def _dense(cfg: ViTConfig | LlamaConfig, fan_in: int, fan_out: int, device) -> LoRADense:
    """A biased dense layer with no adapter, in ``cfg``'s dtypes."""
    return LoRADense(fan_in, fan_out, use_bias=True, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, device=device)


def _vit_act(cfg: ViTConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if cfg.act == "gelu":
        return F.gelu(h)
    raise ValueError(f"unknown ViT activation {cfg.act!r}")


class ViTAttention(nn.Module):
    """Bidirectional multi-head attention with q/k/v/out biases (flax's
    ``MultiHeadDotProductAttention``): the query scaled by 1/sqrt(head dim),
    the scores soft-maxed in f32."""

    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        self.n_heads = cfg.n_heads
        d = cfg.d_model
        self.query = _dense(cfg, d, d, device)
        self.key = _dense(cfg, d, d, device)
        self.value = _dense(cfg, d, d, device)
        self.out = _dense(cfg, d, d, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.n_heads
        q = self.query(x).reshape(b, n, self.n_heads, hd) * hd ** -0.5
        k = self.key(x).reshape(b, n, self.n_heads, hd)
        v = self.value(x).reshape(b, n, self.n_heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(out.reshape(b, n, d))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        norm = dict(eps=cfg.ln_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                    device=device)
        self.ln1 = LayerNorm(cfg.d_model, **norm)
        self.attn = ViTAttention(cfg, device)
        self.ln2 = LayerNorm(cfg.d_model, **norm)
        self.fc1 = _dense(cfg, cfg.d_model, cfg.d_ff, device)
        self.fc2 = _dense(cfg, cfg.d_ff, cfg.d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(_vit_act(self.cfg, self.fc1(self.ln2(x))))


class ViTEncoder(nn.Module):
    """pixels (B, H, W, 3) → (B, n_patches, d_model)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.param_dtype, device=dev)
        p, d = cfg.patch_size, cfg.d_model
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.zeros(d, 3, p, p, **kw))
        self.patch_embed.bias = (nn.Parameter(torch.zeros(d, **kw)) if cfg.patch_bias
                                 else None)
        if cfg.cls_token:
            self.cls = nn.Parameter(torch.zeros(1, 1, d, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.n_patches + cfg.cls_token, d, **kw))
        norm = dict(eps=cfg.ln_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=dev)
        if cfg.pre_norm:
            self.pre_norm = LayerNorm(d, **norm)
        self.blocks = nn.ModuleList(ViTBlock(cfg, dev) for _ in range(cfg.n_run))
        if cfg.feature_layer == 0:
            self.final_norm = LayerNorm(d, **norm)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        pe = self.patch_embed
        bias = pe.bias.to(cfg.dtype) if pe.bias is not None else None
        x = F.conv2d(pixels.to(cfg.dtype).permute(0, 3, 1, 2), pe.kernel.to(cfg.dtype), bias,
                     stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, h·w, d), patches row-major as flax's
        b = x.shape[0]
        if cfg.cls_token:
            x = torch.cat([self.cls.to(cfg.dtype).expand(b, 1, cfg.d_model), x], dim=1)
        x = x + self.pos_embed.to(cfg.dtype)
        if cfg.pre_norm:
            x = self.pre_norm(x)
        for block in self.blocks:
            x = block(x)
        if cfg.feature_layer == 0:
            x = self.final_norm(x)
        if cfg.cls_token:
            x = x[:, 1:]  # feature selection drops the class token
        return x


class LlavaForCausalLM(LlamaForCausalLM):
    """Image-prefix causal LM: :class:`~.llama.LlamaForCausalLM` (the
    decoder, ``text_cfg``) with ``vision_tower``, ``projector_fc1`` and
    ``projector_fc2``.  ``cfg`` is the :class:`LlavaConfig`."""

    def __init__(self, cfg: LlavaConfig, device=None):
        dev = resolve_device(device)
        super().__init__(cfg.text, dev)
        self.cfg = cfg
        tcfg = cfg.text
        self.vision_tower = ViTEncoder(cfg.vision, dev)
        self.projector_fc1 = _dense(tcfg, cfg.vision.d_model, cfg.projector_hidden, dev)
        self.projector_fc2 = _dense(tcfg, cfg.projector_hidden, tcfg.d_model, dev)

    @property
    def text_cfg(self) -> LlamaConfig:
        return self.cfg.text

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) → the image prefix (B, n_patches, d) in the
        decoder's compute dtype: the tower, then the projector (exact GELU,
        as HF's ``multi_modal_projector``)."""
        with torch.profiler.record_function("vision_tower"):
            patches = self.vision_tower(pixels)
        with torch.profiler.record_function("mm_projector"):
            h = F.gelu(self.projector_fc1(patches.to(self.text_cfg.dtype)))
            return self.projector_fc2(h)

    def _prefixed(self, tokens, pixels):
        """``[image; text]`` embeddings and the prefix length."""
        x = self._embed(tokens)
        if pixels is None:
            return x, 0
        img = self.encode_image(pixels)
        return torch.cat([img, x], dim=1), img.shape[1]

    def forward(self, tokens: torch.Tensor, pixels: torch.Tensor | None = None,
                segment_ids: torch.Tensor | None = None,
                adapter_ids: torch.Tensor | None = None, tenants=None,
                return_moe_aux: bool = False):
        """(B, S) tokens and optional (B, H, W, 3) pixels -> (B, S, V)
        logits of the text positions.  Positions run over the combined
        sequence; with ``segment_ids`` the image prefix joins each row's
        first text segment."""
        b, s = tokens.shape
        x, n_img = self._prefixed(tokens, pixels)
        total = n_img + s
        positions = torch.arange(total, device=tokens.device).expand(b, total)
        if segment_ids is not None and n_img:
            segment_ids = torch.cat([segment_ids[:, :1].expand(b, n_img), segment_ids], dim=1)
        x, aux_sum = self.forward_embeddings(x, positions, segment_ids, adapter_ids, tenants)
        logits = self._head(x[:, n_img:])  # logits for the text positions only
        return (logits, aux_sum) if return_moe_aux else logits

    @torch.no_grad()
    def forward_cached(self, tokens, positions, kv: DenseKV, idx, *, fresh: bool = False,
                       last_idx: int | None = None, adapter_ids=None, tenants=None,
                       pixels: torch.Tensor | None = None) -> torch.Tensor:
        """:meth:`~.llama.LlamaForCausalLM.forward_cached`; with ``pixels``
        the chunk is ``[image; tokens]`` and ``positions`` (B, n_patches + S)
        and ``last_idx`` count the prefix."""
        x, _ = self._prefixed(tokens, pixels)
        return self.forward_cached_embeddings(x, positions, kv, idx, fresh=fresh,
                                              last_idx=last_idx, adapter_ids=adapter_ids,
                                              tenants=tenants)


MM_PRESETS: dict[str, LlavaConfig] = {
    "llava-1.5-7b": LlavaConfig(
        # CLIP ViT-L/14 @ 336px with LLaVA-1.5 semantics: class token, CLIP
        # pre-norm, quick-gelu, bias-free patch conv, penultimate-layer
        # features — the tower llava-hf/llava-1.5-7b-hf ships
        vision=ViTConfig(cls_token=True, pre_norm=True, patch_bias=False,
                         act="quick_gelu", feature_layer=-2),
        text=LlamaConfig(
            vocab_size=32064, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=32, d_ff=11008, max_seq_len=4096, attention_impl="auto",
        ),
        projector_hidden=4096,
    ),
    "tiny-mm-test": LlavaConfig(
        vision=ViTConfig(image_size=16, patch_size=8, d_model=32, n_layers=2,
                         n_heads=2, d_ff=64),
        text=LlamaConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128,
        ),
        projector_hidden=64,
    ),
    # a miniature llava-1.5-7b (class token, pre-norm, quick-gelu,
    # penultimate-layer features), loadable from a tiny HF LLaVA checkpoint
    "tiny-mm-clip-test": LlavaConfig(
        vision=ViTConfig(image_size=16, patch_size=8, d_model=32, n_layers=3,
                         n_heads=2, d_ff=64, cls_token=True, pre_norm=True,
                         patch_bias=False, act="quick_gelu", feature_layer=-2),
        text=LlamaConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, rms_eps=1e-6,
        ),
        projector_hidden=64,
    ),
}
