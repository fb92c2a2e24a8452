"""LoRA adapters on the projection layers (counterpart of ``models/lora.py``).

The frozen base kernel and the adapter factors are parameters of one
``LoRADense``.  The kernel keeps flax's ``(in, out)`` layout, so a weight
converted from the JAX tree (``models/convert.py``) is used as it is:
``y = x @ W``.

LoRA dropout (``lora.dropout > 0``, training mode) drops adapter inputs as
flax's ``nn.Dropout`` does (keep with probability 1 - rate, scale kept values
by 1 / (1 - rate)).  Each adapter draws its mask from a ``torch.Generator``
seeded from the seed the trainer sets (``set_dropout_seed``) and the
adapter's index, so a rematerialised forward redraws the same mask.  The
bits differ from JAX's; only the distribution matches.

The multi-tenant branch of the reference (stacked per-tenant adapters
selected per batch row) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

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
        device: torch.device | str | None = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.lora_rank = lora_rank
        self.scale = lora_alpha / lora_rank if lora_rank else 0.0
        self.dropout = lora_dropout
        #: set by the model: the adapter's index and the trainer's seed
        self.dropout_index = 0
        self.dropout_seed: int | None = None
        kw = dict(dtype=param_dtype, device=device)
        self.kernel = nn.Parameter(torch.zeros(in_features, features, **kw))
        self.bias = (nn.Parameter(torch.zeros(features, **kw))
                     if use_bias else None)
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(in_features, lora_rank, **kw))
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, features, **kw))
        else:
            self.lora_a = self.lora_b = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.lora_a is not None:
            h = self._dropout(x) if self.dropout > 0.0 and self.training else x
            # same evaluation order as the reference: ((h @ A) @ B) * scale
            y = y + (h @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype) * self.scale
        return y

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        if self.dropout_seed is None:
            raise RuntimeError("LoRA dropout needs a seed: call model.set_dropout_seed(seed)")
        gen = torch.Generator(device=x.device)
        gen.manual_seed((self.dropout_seed * 1_000_003 + self.dropout_index) % (1 << 63))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.dropout
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros((), dtype=x.dtype,
                                                                        device=x.device))
