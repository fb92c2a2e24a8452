"""LoRA adapters on the projection layers (counterpart of ``models/lora.py``).

The frozen base kernel and the adapter factors are parameters of one
``LoRADense``.  The kernel keeps flax's ``(in, out)`` layout, so a weight
converted from the JAX tree (``models/convert.py``) is used as it is:
``y = x @ W``.

With ``quantize_base`` (QLoRA, the reference's ``lora.py`` kernel branch)
the frozen kernel is stored as blockwise int4 (``models/quant.py``): the
non-trainable buffers ``kernel_packed`` (uint8, ``(in/2, out)``) and
``kernel_scales`` (bf16, ``(in/block, out)``) take the place of the
``kernel`` parameter, and the product runs through ``quant.int4_matmul``,
which dequantizes at use and keeps no dequantized weight for the backward.

``adapter_enabled = False`` (set for a whole model by
``LlamaForCausalLM.adapters_disabled``) skips the ``lora_a``/``lora_b``
branch, so the same weights give the adapterless base's output: the DPO
reference forward.  An int4 base still runs ``int4_matmul``.

LoRA dropout (``lora.dropout > 0``, training mode) drops adapter inputs as
flax's ``nn.Dropout`` does (keep with probability 1 - rate, scale kept values
by 1 / (1 - rate)).  Each adapter draws its mask from a ``torch.Generator``
seeded from the seed the trainer sets (``set_dropout_seed``) and the
adapter's index, so a rematerialised forward redraws the same mask.  The
bits differ from JAX's; only the distribution matches.

Multi-tenant serving (the reference's ``tenant_slots`` branch,
``lora.py:59-67`` and ``:114-138``): :class:`TenantStacks` holds N stacked
per-tenant adapters for every projection of every layer, and each batch row
applies the adapter its entry in ``adapter_ids`` names.  Slot 0 is the base
model (all-zero stack, scale 0: its delta is an exact 0.0); a tenant whose
rank is below the stack rank is zero-padded.  The stacks are buffers, one
``(L, N, in, R)`` / ``(L, N, R, out)`` / ``(L, N)`` triple per projection
kind (the reference's scanned ``"tenants"`` leaves), so a forward gathers
the rows' adapters once per kind for all layers (:meth:`TenantStacks.select`)
and :meth:`LoRADense.forward` takes its layer's gathered slice.  They are
stored in the compute dtype: the reference keeps them in ``param_dtype`` and
casts at use, and a cast at store time rounds the same values to the same
bits.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from .quant import int4_matmul

DEFAULT_TARGETS = (
    "q_proj",
    "k_proj",
    "v_proj",
    "o_proj",
    "gate_proj",
    "up_proj",
    "down_proj",
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 0            # 0 disables LoRA (full fine-tune)
    alpha: float = 16.0
    dropout: float = 0.0
    targets: Sequence[str] = DEFAULT_TARGETS

    def enabled_for(self, name: str) -> bool:
        return self.rank > 0 and name in self.targets


class LoRADense(nn.Module):
    """Dense layer with an optional low-rank adapter branch.

    ``y = x @ W (+ b)  +  (alpha / r) * (x @ A) @ B`` with ``A: (in, r)`` and
    ``B: (r, out)``.  Every matmul runs in the compute ``dtype``: parameters
    are cast at use, exactly as the reference casts its f32 params
    (``lora.py:86``).  A parameter already stored in ``dtype`` (the serving
    path keeps the base in bf16 on the card) makes that cast a no-op with
    the same result.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        lora_rank: int = 0,
        lora_alpha: float = 16.0,
        lora_dropout: float = 0.0,
        use_bias: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        quantize_base: bool = False,
        quant_block: int = 64,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.scale = lora_alpha / lora_rank if lora_rank else 0.0
        self.dropout = lora_dropout
        #: False skips the adapter branch (the adapterless base's output)
        self.adapter_enabled = True
        #: set by the model: the adapter's index and the trainer's seed
        self.dropout_index = 0
        self.dropout_seed: int | None = None
        kw = dict(dtype=param_dtype, device=device)
        if quantize_base:
            self.register_parameter("kernel", None)
            self.register_buffer("kernel_packed", torch.zeros(
                in_features // 2, features, dtype=torch.uint8, device=device))
            self.register_buffer("kernel_scales", torch.zeros(
                in_features // quant_block, features, dtype=torch.bfloat16, device=device))
        else:
            self.kernel = nn.Parameter(torch.zeros(in_features, features, **kw))
        self.bias = (nn.Parameter(torch.zeros(features, **kw))
                     if use_bias else None)
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(in_features, lora_rank, **kw))
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, features, **kw))
        else:
            self.lora_a = self.lora_b = None

    def forward(self, x: torch.Tensor, tenant: "TenantRows | None" = None) -> torch.Tensor:
        """``tenant`` is this projection's slice of :meth:`TenantStacks.select`:
        per-row ``A (B, in, R)``, ``B (B, R, out)`` and ``scale (B,)`` in the
        compute dtype, applied as ``y_b += scale_b * (x_b @ A_b) @ B_b``."""
        if self.kernel is None:
            y = int4_matmul(x, self.kernel_packed, self.kernel_scales, self.dtype)
        else:
            y = x @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.lora_a is not None and self.adapter_enabled:
            h = self._dropout(x) if self.dropout > 0.0 and self.training else x
            # same evaluation order as the reference: ((h @ A) @ B) * scale
            y = y + (h @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype) * self.scale
        if tenant is not None:
            # the reference's order: gather (done by select), bsi,bir->bsr,
            # bsr,bro->bso, then the per-row scale
            a, b, scale = tenant
            delta = torch.bmm(torch.bmm(x, a), b)
            y = y + delta * scale[:, None, None]
        return y

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout_seed is None:
            raise RuntimeError("LoRA dropout needs a seed: call model.set_dropout_seed(seed)")
        gen = torch.Generator(device=x.device)
        gen.manual_seed((self.dropout_seed * 1_000_003 + self.dropout_index) % (1 << 63))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.dropout
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))


#: one projection's per-row adapters: (A (B, in, R), B (B, R, out), scale (B,))
TenantRows = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class _Stack(nn.Module):
    """One projection kind's stacks across ``L`` layers and ``N`` slots."""

    def __init__(self, n_layers: int, slots: int, rank: int, in_features: int,
                 features: int, dtype: torch.dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.register_buffer("lora_a", torch.zeros(n_layers, slots, in_features, rank, **kw))
        self.register_buffer("lora_b", torch.zeros(n_layers, slots, rank, features, **kw))
        self.register_buffer("scale", torch.zeros(n_layers, slots, **kw))


class TenantStacks(nn.Module):
    """Stacked per-tenant adapters of every projection of every layer.

    ``shapes`` maps each projection name to its ``(in, out)``; the children
    are named after the projections and each holds ``lora_a (L, N, in, R)``,
    ``lora_b (L, N, R, out)`` and ``scale (L, N)`` buffers.  Slot 0 stays
    zero (the base model).  ``serve/adapters.py::install_into`` writes a
    tenant's slot in place; a serving engine does so under its lock, so no
    forward reads a half-written slot."""

    def __init__(self, shapes: dict[str, tuple[int, int]], n_layers: int, slots: int,
                 rank: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.n_layers = n_layers
        for name, (fan_in, fan_out) in shapes.items():
            self.add_module(name, _Stack(n_layers, slots, max(1, rank), fan_in, fan_out,
                                         dtype, device))

    def select(self, adapter_ids: torch.Tensor) -> list[dict[str, TenantRows]]:
        """Per layer, ``{projection: (A, B, scale)}`` gathered for the rows'
        ``adapter_ids`` (B,): one gather per stack for all layers."""
        ids = adapter_ids.to(device=next(self.buffers()).device, dtype=torch.long)
        per_kind = {
            name: tuple(t.index_select(1, ids).unbind(0)
                        for t in (stack.lora_a, stack.lora_b, stack.scale))
            for name, stack in self.named_children()
        }
        return [{name: (a[i], b[i], s[i]) for name, (a, b, s) in per_kind.items()}
                for i in range(self.n_layers)]
