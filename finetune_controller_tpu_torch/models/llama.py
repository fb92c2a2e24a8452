"""Llama-family decoder (RMSNorm + RoPE + GQA + SwiGLU/GeGLU) in PyTorch.

Counterpart of the reference's ``models/llama.py``.  ``LlamaConfig`` and
``PRESETS`` are copied field for field (with torch dtypes) so one spec fits
both packages.  The layer stack is a Python loop over ``nn.ModuleList``
(the reference's ``nn.scan`` has no counterpart here: PyTorch runs
eagerly), and parameter names follow the flax tree so the converter
(``models/convert.py``) is a rename.

Three forward paths:

* :meth:`LlamaForCausalLM.forward` — the full-sequence causal forward of the
  reference's ``__call__`` (``llama.py:742-805``): packing ``segment_ids``,
  attention through ``ops.attention.causal_attention`` (``cfg.attention_impl``:
  the plain path or the CUDA flash kernels), per-layer rematerialisation
  following ``cfg.remat_policy`` while gradients are recorded, and LoRA
  dropout in training mode;
* :meth:`LlamaForCausalLM.forward_paged` — the serving path of the
  reference's ``Attention._paged_decode_attention`` (``llama.py:539-593``):
  the chunk's K/V are written into shared per-layer page pools IN PLACE
  (the reference rebuilt the cache tree on every call) and attention reads
  back through the page table (``ops.attention.paged_cache_attention``, the
  CUDA kernel on the card);
* :meth:`LlamaForCausalLM.forward_cached` — the unpaged serving path of the
  reference's ``Attention._decode_attention`` (``llama.py:461-538``): a
  dense ``(B, M, Hkv, D)`` cache per layer (:class:`DenseKV`), written in
  place; a fresh prefill attends causally over the chunk, a suffix prefill
  and a decode step attend the cache up to each row's index (plain torch
  attention, as the reference runs XLA attention there).

Every path takes ``adapter_ids`` (B,): with tenant stacks (built from
``cfg.lora_tenant_slots``/``lora_tenant_rank``, or passed as ``tenants=`` by
a serving engine that owns its own) each row applies its tenant's adapter
on all seven projections (``models/lora.py``).

Rematerialisation keeps numerics and follows the reference's policies
(``remat_policy_fn``, ``llama.py:31-76``): each keeps the tensors it names
(:data:`REMAT_SAVED`) and the backward recomputes the rest.  The port runs a
block as five stages (:meth:`Block._stages`): ``qkv`` (norm, projections,
RoPE; names ``attn_qkv``), ``flash`` (the attention; ``attn_ctx``, and
``flash_out``/``flash_lse`` inside the kernel's ``FlashAttention``
Function), ``o`` (the output projection and residual; ``attn_o``),
``gate_up`` (norm, gate and up projections; ``mlp_gate``/``mlp_up``) and
``down`` (activation, down projection, residual).  A stage whose named
output the policy keeps runs as it is; consecutive stages that it does not
keep run under one ``torch.utils.checkpoint`` (non-reentrant) segment, split
where a kept tensor crosses between them (its inputs are what the segment
saves).  So the backward re-runs the same projections and the same
attention forwards as the reference's: the flash forward runs once per
layer and step under ``none``, ``flash`` and ``mlp_flash`` (the Function
outside every segment) and twice under the others.  What torch keeps beside
the named tensors differs from what JAX keeps: a stage that runs as it is
saves what its own backward needs (the ``qkv`` stage its normed input, the
``FlashAttention`` Function its q, k and v even where the policy recomputes
them), and the ``down`` segment re-runs the down product as well as the
activation.  An MoE block's experts name nothing: they form one stage that
every policy recomputes, so ``mlp`` recomputes an MoE block whole.

``quantize_base`` stores every projection's kernel as int4 (QLoRA,
``models/quant.py``; the head and the embedding stay float), and
``n_experts`` puts a :class:`~.moe.MoEMLP` named ``moe`` in each block in
place of the dense MLP (``llama.py:620-641``).  The training forward can
return the blocks' summed load-balancing term beside the logits
(``return_moe_aux``); the serving paths drop it.

The stack is open to input embeddings (:meth:`LlamaForCausalLM.
forward_embeddings` and :meth:`~LlamaForCausalLM.forward_cached_embeddings`),
which the multimodal subclass (``models/multimodal.py``) runs over an image
prefix and the text.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import (
    causal_attention,
    chunked_cache_attention,
    paged_cache_attention,
    xla_causal_attention,
)
from .lora import LoRAConfig, LoRADense, TenantRows, TenantStacks
from .moe import EXPERT_KERNELS, MoEMLP
from .quant import quantize_int4

#: the tensors each of the reference's remat policies keeps
#: (``remat_policy_fn``); ``none`` is no rematerialisation
REMAT_SAVED = {
    "full": (),
    "attn": ("attn_ctx",),
    "mlp": ("mlp_gate", "mlp_up"),
    "mlp_qkv": ("mlp_gate", "mlp_up", "attn_qkv"),
    "flash": ("flash_out", "flash_lse"),
    "mlp_flash": ("mlp_gate", "mlp_up", "flash_out", "flash_lse"),
    "wide": ("mlp_gate", "mlp_up", "attn_qkv", "attn_ctx"),
    "matmuls": ("mlp_gate", "mlp_up", "mlp_down", "attn_qkv", "attn_ctx", "attn_o"),
}
REMAT_POLICIES = ("none", *REMAT_SAVED)
#: the names each policy keeps that an MoE block carries (its experts name
#: nothing)
_MOE_NAMES = ("attn_qkv", "attn_ctx", "attn_o", "flash_out", "flash_lse")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    d_ff: int = 5632
    rope_theta: float = 10000.0
    #: llama3-style RoPE frequency scaling; 0.0 disables (see
    #: :func:`rope_inv_freqs`)
    rope_scaling_factor: float = 0.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_len: int = 8192
    max_seq_len: int = 2048
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attention_impl: str = "xla"
    # kernel-tuning knobs of the training path (kept for spec parity)
    flash_block_q: int = 0
    flash_block_k: int = 0
    flash_exp_dtype: str = ""
    ring_inner: str = ""
    ulysses_inner: str = ""
    remat: bool = True
    remat_policy: str = "full"
    #: dtype of the materialised logits; None = float32
    logits_dtype: Any = None
    scan_layers: bool = True
    tie_embeddings: bool = False
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    quantize_base: bool = False
    quant_block: int = 64
    #: attention head dim decoupled from d_model // n_heads; 0 = derived
    head_dim_override: int = 0
    #: "silu" (SwiGLU) | "gelu" (GeGLU, tanh approximation)
    mlp_act: str = "silu"
    #: RMSNorm scale parameterisation: effective scale = offset + stored
    norm_offset: float = 0.0
    #: multiply embedding output by sqrt(d_model) (Gemma)
    embed_scale: bool = False
    #: q/k/v projection biases (Qwen-2)
    attention_qkv_bias: bool = False
    #: paged KV cache: positions per page and pool pages (page 0 = scratch)
    kv_page_tokens: int = 0
    kv_pool_pages: int = 0
    lora_tenant_slots: int = 0
    lora_tenant_rank: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def image_size(self) -> int:
        """Pixels per side of the vision input: 0, a text-only model (the
        surface a multimodal config overrides, so the data path sizes pixel
        batches without a family check)."""
        return 0

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, LlamaConfig] = {
    "tiny-test": LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128,
    ),
    "tinyllama-1.1b": LlamaConfig(attention_impl="auto", remat_policy="mlp"),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, rope_theta=500000.0, max_seq_len=8192, attention_impl="auto",
        remat_policy="mlp",
    ),
    "llama3.2-1b": LlamaConfig(
        vocab_size=128256, d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        d_ff=8192, rope_theta=500000.0, max_seq_len=131072,
        tie_embeddings=True, rope_scaling_factor=32.0,
        attention_impl="auto", remat_policy="mlp",
    ),
    "llama3.2-3b": LlamaConfig(
        vocab_size=128256, d_model=3072, n_layers=28, n_heads=24, n_kv_heads=8,
        d_ff=8192, rope_theta=500000.0, max_seq_len=131072,
        tie_embeddings=True, rope_scaling_factor=32.0,
        attention_impl="auto", remat_policy="mlp",
    ),
    "mistral-7b": LlamaConfig(
        vocab_size=32768, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=8192, attention_impl="auto", remat_policy="mlp",
    ),
    "mistral-7b-32k": LlamaConfig(
        vocab_size=32768, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=32768, rope_theta=1_000_000.0,
        attention_impl="auto", remat_policy="mlp",
    ),
    "mixtral-8x7b": LlamaConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=8192, n_experts=8, moe_top_k=2,
        attention_impl="auto",
    ),
    "mixtral-proxy": LlamaConfig(
        vocab_size=32000, d_model=2048, n_layers=12, n_heads=16, n_kv_heads=8,
        d_ff=5632, max_seq_len=8192, n_experts=8, moe_top_k=2,
        attention_impl="auto", remat_policy="mlp",
    ),
    "mixtral-proxy-10b": LlamaConfig(
        vocab_size=32000, d_model=3072, n_layers=16, n_heads=24, n_kv_heads=8,
        d_ff=8192, max_seq_len=8192, n_experts=8, moe_top_k=2,
        attention_impl="auto", remat_policy="full",
    ),
    "gemma-2b": LlamaConfig(
        vocab_size=256000, d_model=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        d_ff=16384, max_seq_len=8192, head_dim_override=256, mlp_act="gelu",
        norm_offset=1.0, embed_scale=True, tie_embeddings=True,
        rms_eps=1e-6, attention_impl="auto", remat_policy="mlp",
    ),
    "gemma-7b": LlamaConfig(
        vocab_size=256000, d_model=3072, n_layers=28, n_heads=16, n_kv_heads=16,
        d_ff=24576, max_seq_len=8192, head_dim_override=256, mlp_act="gelu",
        norm_offset=1.0, embed_scale=True, tie_embeddings=True,
        rms_eps=1e-6, attention_impl="auto", remat_policy="mlp",
    ),
    "tiny-gemma-test": LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, head_dim_override=32, mlp_act="gelu",
        norm_offset=1.0, embed_scale=True, tie_embeddings=True, rms_eps=1e-6,
    ),
    "qwen2-7b": LlamaConfig(
        vocab_size=152064, d_model=3584, n_layers=28, n_heads=28, n_kv_heads=4,
        d_ff=18944, rope_theta=1_000_000.0, max_seq_len=8192, rms_eps=1e-6,
        attention_qkv_bias=True, attention_impl="auto", remat_policy="mlp",
    ),
    "tiny-qwen-test": LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, rms_eps=1e-6, attention_qkv_bias=True,
    ),
    "tiny-moe-test": LlamaConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=128, n_experts=4, moe_top_k=2,
    ),
}


def remat_mode(cfg: LlamaConfig) -> str:
    """The per-layer remat the forward applies: a key of
    :data:`REMAT_SAVED`, or ``none``.  Raises for an unknown policy (the
    reference's message).

    An MoE block names none of the MLP's tensors, so a policy that keeps
    nothing an MoE block names (``mlp``) recomputes the whole block:
    ``full``."""
    name = cfg.remat_policy
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of {list(REMAT_POLICIES)}")
    if not cfg.remat or name == "none":
        return "none"
    if cfg.n_experts and not set(REMAT_SAVED[name]) & set(_MOE_NAMES):
        return "full"
    return name


def rope_inv_freqs(cfg: LlamaConfig, device=None) -> torch.Tensor:
    """Per-pair inverse frequencies in f32, with optional llama3 scaling
    (the reference's ``rope_inv_freqs``, ``llama.py:330-356``)."""
    half = cfg.head_dim // 2
    freqs = 1.0 / (
        cfg.rope_theta ** (torch.arange(half, dtype=torch.float32, device=device) / half)
    )
    factor = cfg.rope_scaling_factor
    if not factor:
        return freqs
    orig = cfg.rope_scaling_original_max_len
    low_f, high_f = cfg.rope_scaling_low_freq_factor, cfg.rope_scaling_high_freq_factor
    low_wl, high_wl = orig / low_f, orig / high_f
    wavelen = 2.0 * math.pi / freqs
    smooth = (orig / wavelen - low_f) / (high_f - low_f)
    smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(
        wavelen > low_wl, freqs / factor,
        torch.where(wavelen < high_wl, freqs, smoothed),
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freqs: torch.Tensor) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S), ``inv_freqs``
    from :func:`rope_inv_freqs`.  The angles and the rotation are computed
    in f32 and the result cast back to ``x.dtype``, as in the reference."""
    half = x.shape[-1] // 2
    angles = positions[..., None].to(torch.float32) * inv_freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """RMS normalisation in f32; effective scale = ``offset`` + stored
    ``scale`` (0.0 = Llama, ones init; 1.0 = Gemma, zeros init)."""

    def __init__(self, dim: int, eps: float, dtype, param_dtype,
                 offset: float = 0.0, device=None):
        super().__init__()
        self.eps, self.dtype, self.offset = eps, dtype, offset
        init = torch.zeros if offset else torch.ones
        self.scale = nn.Parameter(init(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * (self.offset + self.scale.to(torch.float32))).to(self.dtype)


def _proj(cfg: LlamaConfig, name: str, in_features: int, features: int,
          device) -> LoRADense:
    lora_on = cfg.lora.enabled_for(name)
    return LoRADense(
        in_features, features,
        lora_rank=cfg.lora.rank if lora_on else 0,
        lora_alpha=cfg.lora.alpha,
        lora_dropout=cfg.lora.dropout,
        use_bias=cfg.attention_qkv_bias and name in ("q_proj", "k_proj", "v_proj"),
        dtype=cfg.dtype, param_dtype=cfg.param_dtype, quantize_base=cfg.quantize_base,
        quant_block=cfg.quant_block, device=device,
    )


def tenant_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    """``(in, out)`` of each of the seven projections (every one carries a
    tenant stack, as in the reference, whatever ``cfg.lora.targets`` says)."""
    hd, d = cfg.head_dim, cfg.d_model
    return {
        "q_proj": (d, cfg.n_heads * hd), "k_proj": (d, cfg.n_kv_heads * hd),
        "v_proj": (d, cfg.n_kv_heads * hd), "o_proj": (cfg.n_heads * hd, d),
        "gate_proj": (d, cfg.d_ff), "up_proj": (d, cfg.d_ff), "down_proj": (cfg.d_ff, d),
    }


def tenant_stacks(cfg: LlamaConfig, slots: int, rank: int, device=None) -> TenantStacks:
    """Zero tenant stacks for ``cfg``'s layers in its compute dtype."""
    return TenantStacks(tenant_shapes(cfg), cfg.n_layers, slots, rank, cfg.dtype, device)


@dataclasses.dataclass
class PagedKV:
    """The serving KV cache: one (P, T, Hkv, D) page pool per layer for K
    and for V, stacked as ``(L, P, T, Hkv, D)`` tensors.  Page 0 is the
    scratch page.  Updated in place by :meth:`Attention.forward_paged`."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: LlamaConfig, pool_pages: int, page_tokens: int,
              device) -> "PagedKV":
        shape = (cfg.n_layers, pool_pages, page_tokens, cfg.n_kv_heads,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))

    @property
    def page_bytes(self) -> int:
        """Bytes of one page id across every layer's K and V pools."""
        return 2 * self.k[:, 0].numel() * self.k.element_size()

    def copy_page(self, dst: int, src: int) -> None:
        """Copy-on-write: duplicate page ``src`` into ``dst`` in every
        layer's K and V pool."""
        self.k[:, dst] = self.k[:, src]
        self.v[:, dst] = self.v[:, src]


@dataclasses.dataclass
class DenseKV:
    """The unpaged serving KV cache: a contiguous ``M``-position stripe per
    lane, ``(L, B, M, Hkv, D)`` for K and for V.  Updated in place by
    :meth:`Attention.forward_cached`; the lanes' cache indexes are the
    caller's (host) state."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, length: int, device) -> "DenseKV":
        shape = (cfg.n_layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))

    @property
    def nbytes(self) -> int:
        return self.k.nbytes + self.v.nbytes

    def clone(self) -> "DenseKV":
        return DenseKV(self.k.clone(), self.v.clone())


def _rows(tenant: dict[str, TenantRows] | None, name: str) -> TenantRows | None:
    return tenant[name] if tenant is not None else None


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        d = cfg.d_model
        self.q_proj = _proj(cfg, "q_proj", d, cfg.n_heads * hd, device)
        self.k_proj = _proj(cfg, "k_proj", d, cfg.n_kv_heads * hd, device)
        self.v_proj = _proj(cfg, "v_proj", d, cfg.n_kv_heads * hd, device)
        self.o_proj = _proj(cfg, "o_proj", cfg.n_heads * hd, d, device)

    def _qkv(self, x, positions, inv_freqs, tenant=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim
        q = self.q_proj(x, _rows(tenant, "q_proj")).reshape(b, s, cfg.n_heads, hd)
        k = self.k_proj(x, _rows(tenant, "k_proj")).reshape(b, s, cfg.n_kv_heads, hd)
        v = self.v_proj(x, _rows(tenant, "v_proj")).reshape(b, s, cfg.n_kv_heads, hd)
        return apply_rope(q, positions, inv_freqs), apply_rope(k, positions, inv_freqs), v

    def _out(self, out, tenant):
        b, s = out.shape[:2]
        return self.o_proj(out.reshape(b, s, -1), _rows(tenant, "o_proj"))

    def forward(self, x, positions, inv_freqs, segment_ids=None, tenant=None):
        q, k, v = self._qkv(x, positions, inv_freqs, tenant)
        out = causal_attention(q, k, v, impl=self.cfg.attention_impl, segment_ids=segment_ids)
        return self._out(out, tenant)

    def forward_paged(self, x, positions, inv_freqs, k_pool, v_pool,
                      page_table, idx, write_at, tenant=None):
        """Scatter the chunk's K/V into this layer's pools at ``write_at``
        (in place; see :func:`paged_write_index`) and attend through the
        page table from each lane's cache index ``idx`` (B,)."""
        q, k, v = self._qkv(x, positions, inv_freqs, tenant)
        k_pool[write_at] = k.to(k_pool.dtype)
        v_pool[write_at] = v.to(v_pool.dtype)
        out = paged_cache_attention(q, k_pool, v_pool, page_table, idx)
        return self._out(out, tenant)

    def forward_cached(self, x, positions, inv_freqs, k_cache, v_cache, idx, fresh,
                       tenant=None):
        """The reference's three regimes of ``_decode_attention`` over a
        (B, M, Hkv, D) cache: ``fresh`` writes the chunk at [0, S) and
        attends causally within it; otherwise the chunk lands at each row's
        index ``idx`` (B,) and attends the cache up to itself.  A single
        token's write clamps to the last slot, so a parked lane stays in
        bounds."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, positions, inv_freqs, tenant)
        if fresh:
            k_cache[:, :s] = k
            v_cache[:, :s] = v
            out = xla_causal_attention(q, k, v)
        else:
            rows = torch.arange(b, device=x.device)[:, None]
            cols = idx.long()[:, None] + torch.arange(s, device=x.device)[None, :]
            cols = torch.clamp(cols, max=k_cache.shape[1] - 1) if s == 1 else cols
            k_cache[rows, cols] = k.to(k_cache.dtype)
            v_cache[rows, cols] = v.to(v_cache.dtype)
            out = chunked_cache_attention(q, k_cache, v_cache, idx)
        return self._out(out, tenant)


def paged_write_index(page_table: torch.Tensor, idx: torch.Tensor, s: int,
                      page_tokens: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(page, offset)`` index tensors, each (B, S), where a chunk of S
    tokens starting at cache index ``idx`` (B,) lands in the pools.

    The cache index and the RoPE positions are separate inputs.  Write
    positions clamp to the lane's last logical slot, as in the reference
    (``llama.py:583-588``): a parked lane (all-zero table row) and a
    bucket-padded prefill tail past the lane's materialized pages both
    write into the scratch page 0, which no live lane reads unmasked.
    """
    cap = page_table.shape[1] * page_tokens
    pos = idx.long()[:, None] + torch.arange(s, device=idx.device)[None, :]
    pos_w = torch.clamp(pos, max=cap - 1)
    phys = torch.gather(page_table.long(), 1, pos_w // page_tokens)
    return phys, pos_w % page_tokens


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.gelu = cfg.mlp_act == "gelu"
        self.gate_proj = _proj(cfg, "gate_proj", cfg.d_model, cfg.d_ff, device)
        self.up_proj = _proj(cfg, "up_proj", cfg.d_model, cfg.d_ff, device)
        self.down_proj = _proj(cfg, "down_proj", cfg.d_ff, cfg.d_model, device)

    def gate_up(self, x, tenant=None):
        return (self.gate_proj(x, _rows(tenant, "gate_proj")),
                self.up_proj(x, _rows(tenant, "up_proj")))

    def down(self, gate, up, tenant=None):
        # GeGLU uses the tanh approximation, as flax's nn.gelu does
        act = F.gelu(gate, approximate="tanh") if self.gelu else F.silu(gate)
        return self.down_proj(act * up, _rows(tenant, "down_proj"))

    def forward(self, x, tenant=None):
        return self.down(*self.gate_up(x, tenant), tenant)


def _chain(fns):
    def run(*carry):
        for fn in fns:
            carry = fn(*carry)
        return carry

    return run


class Block(nn.Module):
    """One decoder layer.  :meth:`forward` returns ``(x, aux)``: ``aux`` is
    the MoE load-balancing term of the layer, ``None`` for a dense MLP."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        norm = dict(eps=cfg.rms_eps, dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                    offset=cfg.norm_offset, device=device)
        self.attn_norm = RMSNorm(cfg.d_model, **norm)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.d_model, **norm)
        if cfg.n_experts:
            self.moe = MoEMLP(cfg.d_model, cfg.d_ff, cfg.n_experts, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.capacity_factor, dtype=cfg.dtype,
                              param_dtype=cfg.param_dtype, quantize_base=cfg.quantize_base,
                              quant_block=cfg.quant_block, device=device)
        else:
            self.mlp = MLP(cfg, device)

    def _attn_residual(self, x, positions, inv_freqs, segment_ids, tenant=None):
        return x + self.attn(self.attn_norm(x), positions, inv_freqs, segment_ids, tenant)

    def _ffn(self, h, tenant):
        """The MLP or the experts on the normed ``h``: ``(out, aux)``."""
        if hasattr(self, "moe"):
            return self.moe(h)
        return self.mlp(h, tenant), None

    def _forward(self, x, positions, inv_freqs, segment_ids, tenant=None):
        x = self._attn_residual(x, positions, inv_freqs, segment_ids, tenant)
        out, aux = self._ffn(self.mlp_norm(x), tenant)
        return x + out, aux

    def _stages(self, positions, inv_freqs, segment_ids, tenant, saved):
        """The block as ``(stage, carry -> carry, keeps its output, output
        kept for the next stage)`` over a carry tuple, per the policy's
        ``saved`` names (see the module docstring)."""
        attn, impl = self.attn, self.attn.cfg.attention_impl

        def qkv(x):
            return (x, *attn._qkv(self.attn_norm(x), positions, inv_freqs, tenant))

        def flash(x, q, k, v):
            return x, causal_attention(q, k, v, impl=impl, segment_ids=segment_ids)

        def o(x, ctx):
            return (x + attn._out(ctx, tenant),)

        stages = [("qkv", qkv, "attn_qkv" in saved, "attn_qkv" in saved),
                  ("flash", flash, "flash_out" in saved, "attn_ctx" in saved),
                  ("o", o, "attn_o" in saved, "attn_o" in saved)]
        if hasattr(self, "moe"):
            def moe(x):
                out, aux = self.moe(self.mlp_norm(x))
                return x + out, aux

            return stages + [("moe", moe, False, True)]

        def gate_up(x):
            return (x, *self.mlp.gate_up(self.mlp_norm(x), tenant))

        def down(x, gate, up):
            return x + self.mlp.down(gate, up, tenant), None

        kept = "mlp_gate" in saved
        return stages + [("gate_up", gate_up, kept, kept), ("down", down, False, True)]

    def forward(self, x, positions, inv_freqs, segment_ids=None, remat: str = "none",
                tenant=None):
        if remat == "none":
            return self._forward(x, positions, inv_freqs, segment_ids, tenant)
        stages = self._stages(positions, inv_freqs, segment_ids, tenant, REMAT_SAVED[remat])
        carry, i = (x,), 0
        while i < len(stages):
            if stages[i][2]:  # kept: runs as it is, autograd saves its inputs
                carry = stages[i][1](*carry)
                i += 1
                continue
            segment = []
            while i < len(stages) and not stages[i][2]:
                segment.append(stages[i][1])
                i += 1
                if stages[i - 1][3]:
                    break  # its output is kept: the next segment saves it
            carry = checkpoint(_chain(segment), *carry, use_reentrant=False)
        return carry

    def forward_paged(self, x, positions, inv_freqs, k_pool, v_pool,
                      page_table, idx, write_at, tenant=None):
        x = x + self.attn.forward_paged(self.attn_norm(x), positions, inv_freqs,
                                        k_pool, v_pool, page_table, idx, write_at, tenant)
        return x + self._ffn(self.mlp_norm(x), tenant)[0]

    def forward_cached(self, x, positions, inv_freqs, k_cache, v_cache, idx, fresh,
                       tenant=None):
        x = x + self.attn.forward_cached(self.attn_norm(x), positions, inv_freqs,
                                         k_cache, v_cache, idx, fresh, tenant)
        return x + self._ffn(self.mlp_norm(x), tenant)[0]


class LlamaForCausalLM(nn.Module):
    """The decoder.  Parameters are created on ``device`` (CUDA unless the
    caller passes ``device="cpu"``) in ``cfg.param_dtype``; the serving path
    sets ``param_dtype`` to the compute dtype so the base is stored in bf16
    on the card."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed_tokens = nn.Module()
        self.embed_tokens.embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.d_model, dtype=cfg.param_dtype, device=dev)
        )
        self.layers = nn.ModuleList(Block(cfg, dev) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.rms_eps, cfg.dtype,
                                  cfg.param_dtype, cfg.norm_offset, dev)
        self.lm_head = (None if cfg.tie_embeddings else LoRADense(
            cfg.d_model, cfg.vocab_size, dtype=cfg.dtype,
            param_dtype=cfg.param_dtype, device=dev,
        ))
        self.register_buffer("inv_freqs", rope_inv_freqs(cfg, dev), persistent=False)
        #: the model's own tenant stacks (``cfg.lora_tenant_slots > 0``); a
        #: serving engine passes its own as ``tenants=`` instead
        self.tenants = (tenant_stacks(cfg, cfg.lora_tenant_slots, cfg.lora_tenant_rank, dev)
                        if cfg.lora_tenant_slots else None)
        for index, module in enumerate(m for m in self.modules() if isinstance(m, LoRADense)):
            module.dropout_index = index

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.embedding.device

    @property
    def text_cfg(self) -> LlamaConfig:
        """The decoder's config (a multimodal subclass's ``cfg`` holds it
        as ``text``)."""
        return self.cfg

    def _embed(self, tokens):
        cfg = self.text_cfg
        x = self.embed_tokens.embedding.to(cfg.dtype)[tokens]
        if cfg.embed_scale:
            # the scale rounds through the compute dtype before multiplying
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype, device=x.device)
        return x

    def _head(self, x):
        cfg = self.text_cfg
        x = self.final_norm(x)
        if cfg.tie_embeddings:
            logits = x @ self.embed_tokens.embedding.to(cfg.dtype).T
        else:
            logits = self.lm_head(x)
        return logits.to(cfg.logits_dtype or torch.float32)

    def _tenant_rows(self, adapter_ids, tenants) -> list:
        """Per layer, the rows' gathered tenant adapters (``None`` entries
        without ``adapter_ids``)."""
        if adapter_ids is None:
            return [None] * self.text_cfg.n_layers
        stacks = tenants if tenants is not None else self.tenants
        if stacks is None:
            raise ValueError("adapter_ids given, but the model has no tenant stacks "
                             "(lora_tenant_slots=0) and none were passed")
        return stacks.select(adapter_ids)

    def forward(self, tokens: torch.Tensor,
                segment_ids: torch.Tensor | None = None,
                adapter_ids: torch.Tensor | None = None,
                tenants: TenantStacks | None = None,
                return_moe_aux: bool = False):
        """Full-sequence causal forward: (B, S) tokens -> (B, S, V) logits.
        ``segment_ids`` (B, S) keeps packed documents from attending to each
        other; positions run 0..S-1 across the row, as in the reference.
        ``adapter_ids`` (B,) selects each row's tenant adapter.  With
        ``return_moe_aux`` it returns ``(logits, aux)``, ``aux`` the f32 sum
        of the MoE layers' load-balancing terms (0 for a dense model), the
        reference's ``moe_aux_loss`` of the sown collection."""
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        x, aux_sum = self.forward_embeddings(self._embed(tokens), positions, segment_ids,
                                             adapter_ids, tenants)
        logits = self._head(x)
        return (logits, aux_sum) if return_moe_aux else logits

    def forward_embeddings(self, x: torch.Tensor, positions: torch.Tensor,
                           segment_ids: torch.Tensor | None = None,
                           adapter_ids: torch.Tensor | None = None,
                           tenants: TenantStacks | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder layers over input embeddings ``x`` (B, S, d) at
        ``positions`` (B, S), rematerialised per ``remat_policy`` while
        gradients are recorded: ``(hidden, aux)``, the hidden states before
        the final norm and the summed MoE term."""
        remat = remat_mode(self.text_cfg) if torch.is_grad_enabled() else "none"
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, tenant in zip(self.layers, self._tenant_rows(adapter_ids, tenants)):
            x, aux = layer(x, positions, self.inv_freqs, segment_ids, remat, tenant)
            if aux is not None:
                aux_sum = aux_sum + aux
        return x, aux_sum

    @contextlib.contextmanager
    def adapters_disabled(self):
        """Within the block every ``LoRADense`` skips its adapter branch: the
        forward is the adapterless base's, on the same weights (no second
        copy), and no gradient can reach the adapters."""
        layers = [m for m in self.modules() if isinstance(m, LoRADense)]
        for m in layers:
            m.adapter_enabled = False
        try:
            yield self
        finally:
            for m in layers:
                m.adapter_enabled = True

    def set_dropout_seed(self, seed: int) -> None:
        """Seed every adapter's dropout for the next forward (training mode,
        ``lora.dropout > 0``).  Each adapter draws from its own generator
        seeded from ``seed`` and its index, so a rematerialised forward
        redraws the same mask."""
        for module in self.modules():
            if isinstance(module, LoRADense):
                module.dropout_seed = seed

    @torch.no_grad()
    def forward_paged(self, tokens, positions, kv: PagedKV, page_table, idx,
                      last_idx: int | None = None, adapter_ids=None,
                      tenants: TenantStacks | None = None) -> torch.Tensor:
        """Paged serving forward over a chunk of S tokens per lane.

        ``tokens``/``positions`` (B, S); ``page_table`` (B, MP) int32;
        ``idx`` (B,) int32 cache index of each lane's first token.  Writes the
        chunk's K/V into ``kv`` in place.  Returns (B, S, V) logits, or the
        (B, V) row at chunk offset ``last_idx`` when given (the head then
        runs on that row only)."""
        x = self._embed(tokens)
        write_at = paged_write_index(page_table, idx, tokens.shape[1], kv.k.shape[2])
        rows = self._tenant_rows(adapter_ids, tenants)
        for layer, k_pool, v_pool, tenant in zip(self.layers, kv.k, kv.v, rows):
            x = layer.forward_paged(x, positions, self.inv_freqs, k_pool, v_pool,
                                    page_table, idx, write_at, tenant)
        if last_idx is not None:
            x = x[:, last_idx]
        return self._head(x)

    @torch.no_grad()
    def forward_cached(self, tokens, positions, kv: DenseKV, idx, *, fresh: bool = False,
                       last_idx: int | None = None, adapter_ids=None,
                       tenants: TenantStacks | None = None) -> torch.Tensor:
        """Unpaged serving forward over a chunk of S tokens per lane against
        ``kv`` (written in place): ``fresh`` prefills from position 0,
        otherwise the chunk continues each lane's cache at ``idx`` (B,).
        Returns logits as :meth:`forward_paged` does."""
        return self.forward_cached_embeddings(self._embed(tokens), positions, kv, idx,
                                              fresh=fresh, last_idx=last_idx,
                                              adapter_ids=adapter_ids, tenants=tenants)

    @torch.no_grad()
    def forward_cached_embeddings(self, x, positions, kv: DenseKV, idx, *, fresh: bool = False,
                                  last_idx: int | None = None, adapter_ids=None,
                                  tenants: TenantStacks | None = None) -> torch.Tensor:
        """:meth:`forward_cached` over input embeddings ``x`` (B, S, d)."""
        rows = self._tenant_rows(adapter_ids, tenants)
        for layer, k_cache, v_cache, tenant in zip(self.layers, kv.k, kv.v, rows):
            x = layer.forward_cached(x, positions, self.inv_freqs, k_cache, v_cache, idx,
                                     fresh, tenant)
        if last_idx is not None:
            x = x[:, last_idx]
        return self._head(x)


def int4_stems(module: nn.Module) -> tuple[str, ...]:
    """The kernels ``module`` itself stores as int4 (``{stem}_packed`` and
    ``{stem}_scales`` buffers): ``kernel`` of a quantized ``LoRADense``,
    the three expert stacks of a quantized ``MoEMLP``."""
    if isinstance(module, LoRADense) and module.kernel is None:
        return ("kernel",)
    if isinstance(module, MoEMLP) and module.quantized:
        return EXPERT_KERNELS
    return ()


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """``p`` ~ N(0, std²), drawn in f32 and cast to ``p``'s dtype: a base
    stored in bf16 (``frozen_dtype``, the serving loader) is the rounding
    of the f32 draw, and the generator advances as for an f32 base."""
    if p.dtype == torch.float32:
        p.normal_(0.0, std, generator=gen)
    else:
        p.copy_(torch.empty(p.shape, dtype=torch.float32, device=p.device)
                .normal_(0.0, std, generator=gen))


def _fan_in(p: torch.Tensor) -> int:
    """Inputs per output of a kernel: ``in`` of an ``(in, out)`` matrix or
    an ``(E, in, out)`` stack, ``in·h·w`` of an ``OIHW`` convolution."""
    return p[0].numel() if p.ndim == 4 else p.shape[-2]


def _draw_int4_(module: nn.Module, stem: str, gen: torch.Generator) -> None:
    """Draw ``stem``'s float kernel (or expert stack) ~ N(0, 1/fan_in) in
    f32, quantize it into its ``_packed``/``_scales`` buffers, free it."""
    packed = module.get_buffer(f"{stem}_packed")
    scales = module.get_buffer(f"{stem}_scales")
    shape = packed.shape[:-2] + (packed.shape[-2] * 2, packed.shape[-1])
    w = torch.empty(shape, dtype=torch.float32, device=packed.device)
    w.normal_(0.0, shape[-2] ** -0.5, generator=gen)
    q, s = quantize_int4(w, shape[-2] // scales.shape[-2])
    del w
    packed.copy_(q)
    scales.copy_(s)


@torch.no_grad()
def init_random_(model: LlamaForCausalLM, seed: int) -> LlamaForCausalLM:
    """Fill every parameter from ``seed`` on the model's own device (no
    host copy): kernels (dense, router, expert stacks and a vision tower's
    patch convolution) ~ N(0, 1/fan_in), embeddings ~ N(0, 1/d_model), norm
    scales at their init (ones, or zeros with an offset), biases and LoRA
    ``B`` zero, LoRA ``A`` and a vision tower's class and position
    embeddings ~ N(0, 0.02²).  A multimodal model is filled in module order,
    its decoder first.

    Every draw is taken in f32 whatever the storage dtype, so the same seed
    gives the same base (rounded to the storage dtype) in the trainer and in
    the serving loader.  An int4 kernel is drawn in the order a float one
    would be, then
    quantized on the device and the draw freed (the reference's "one weight
    draw" per matrix, ``quant.py:70-96``): one matrix, or one layer's
    ``(E, in, out)`` expert stack, exists in f32 at a time."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for module in model.modules():
        stems = int4_stems(module)
        # registration order, with a quantized LoRADense's ``kernel`` (None)
        # in its place; an MoE's int4 expert stacks come after the router
        for leaf, p in module._parameters.items():
            if p is None:
                if leaf in stems:
                    _draw_int4_(module, leaf, gen)
            elif leaf in ("kernel", "router_kernel") or leaf in EXPERT_KERNELS:
                _normal_(p, _fan_in(p) ** -0.5, gen)
            elif leaf == "embedding":
                _normal_(p, p.shape[1] ** -0.5, gen)
            elif leaf in ("lora_a", "cls", "pos_embed"):
                _normal_(p, 0.02, gen)
            elif leaf == "scale":
                p.fill_(0.0 if getattr(module, "offset", 0.0) else 1.0)
            else:  # bias, lora_b
                p.zero_()
        for stem in stems:
            if stem not in module._parameters:
                _draw_int4_(module, stem, gen)
    return model
