"""Mixture-of-Experts FFN, Mixtral-style top-k routing with a static
capacity per expert (counterpart of the reference's ``models/moe.py``).

The routing is the reference's, step for step (``moe.py:55-150``):

- the router runs in f32: ``softmax(x @ router_kernel)``, the top ``k``
  experts per token, their weights renormalised to sum to 1;
- capacity ``C = min(t, max(8, ceil(t / e * capacity_factor * k)))`` with
  ``t = B*S`` of this call (pad tokens included);
- slots are assigned slot-major by a cumulative count (every token's first
  choice before any second choice); a pair past capacity goes to the
  sentinel slot ``e*C``, which the dispatch drops and the combine reads as
  the appended zero row; empty slots compute on the zero row;
- the experts are one batched SwiGLU over ``(E, C, d)``; the combine is
  ``sum_k top_w * out`` in the compute dtype;
- the Switch load-balancing term ``e * sum_e f_e * P_e``, where ``f_e``
  counts every top-k choice (dropped ones too), is returned beside the
  output; the trainer adds ``router_aux_weight`` times its sum over layers.

``torch.topk`` breaks ties differently from ``jax.lax.top_k``, and the
slot-major priority makes the order decide which pairs are dropped, so
the choice is a stable descending sort: on ties the lower expert index
comes first, as ``lax.top_k`` gives it.  Every step is deterministic on
CUDA (the slot assignment counts in integers, the token ids land in
unique slots by indexed assignment), so a rematerialised forward routes
exactly as the first one did.

With ``quantize_base`` the stacked expert kernels are int4
(``models/quant.py`` over the expert axis): buffers ``experts_*_packed``
``(E, in/2, out)`` and ``experts_*_scales`` ``(E, in/block, out)``, used
through ``quant.int4_matmul``.  LoRA never reaches the experts, as in the
reference.

The routing and the dispatch/combine gathers run inside ``torch.profiler``
ranges named ``moe_route`` and ``moe_dispatch``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .quant import int4_matmul

#: the stacked expert kernels of an MoE layer, each ``(E, in, out)``
EXPERT_KERNELS = ("experts_gate", "experts_up", "experts_down")


class Routing(NamedTuple):
    """One call's routing: ``top_w``/``top_idx`` (T, k), ``slot`` (T, k)
    (``e*C`` for a dropped pair), ``token_of_slot`` (e*C,) (``t`` for an
    empty slot), ``capacity`` and the aux term."""

    top_w: torch.Tensor
    top_idx: torch.Tensor
    slot: torch.Tensor
    token_of_slot: torch.Tensor
    capacity: int
    aux: torch.Tensor


def capacity_for(t: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-expert capacity for ``t`` routed tokens (``moe.py:56-58``)."""
    capacity = max(8, math.ceil(t / n_experts * capacity_factor * top_k))
    return min(capacity, t)


class MoEMLP(nn.Module):
    """Drop-in replacement for the dense SwiGLU MLP; :meth:`forward`
    returns ``(out, aux)``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, quantize_base: bool = False,
                 quant_block: int = 64, device=None):
        super().__init__()
        self.d_model, self.d_ff, self.n_experts = d_model, d_ff, n_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.dtype = dtype
        self.quantized = quantize_base
        self.router_kernel = nn.Parameter(
            torch.zeros(d_model, n_experts, dtype=param_dtype, device=device))
        for name in EXPERT_KERNELS:
            fan_in, fan_out = self.kernel_shape(name)
            if quantize_base:
                self.register_buffer(f"{name}_packed", torch.zeros(
                    n_experts, fan_in // 2, fan_out, dtype=torch.uint8, device=device))
                self.register_buffer(f"{name}_scales", torch.zeros(
                    n_experts, fan_in // quant_block, fan_out, dtype=torch.bfloat16,
                    device=device))
            else:
                self.register_parameter(name, nn.Parameter(torch.zeros(
                    n_experts, fan_in, fan_out, dtype=param_dtype, device=device)))

    def kernel_shape(self, name: str) -> tuple[int, int]:
        """``(in, out)`` of one expert's kernel ``name``."""
        d, f = self.d_model, self.d_ff
        return (f, d) if name == "experts_down" else (d, f)

    def route(self, xt: torch.Tensor) -> Routing:
        """Route the (T, d) tokens ``xt``."""
        t = xt.shape[0]
        e, k = self.n_experts, self.top_k
        capacity = capacity_for(t, e, k, self.capacity_factor)
        logits = xt.to(torch.float32) @ self.router_kernel.to(torch.float32)
        probs = torch.softmax(logits, dim=-1)                       # (T, E)
        top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_w, top_idx = top_w[:, :k], top_idx[:, :k]
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

        onehot = F.one_hot(top_idx, e)                              # (T, k, E) int64
        slot_major = onehot.transpose(0, 1).reshape(k * t, e)       # first choices first
        position = torch.cumsum(slot_major, dim=0) - slot_major     # rank within expert
        position = position.reshape(k, t, e).transpose(0, 1)
        pos_idx = (position * onehot).sum(-1)                       # (T, k)
        n_slots = e * capacity
        slot = torch.where(pos_idx < capacity, top_idx * capacity + pos_idx,
                           torch.full_like(pos_idx, n_slots))
        # the slots of routed pairs are unique; the dropped ones all land
        # on the extra entry n_slots, which is cut off
        token_of_slot = torch.full((n_slots + 1,), t, dtype=torch.long, device=xt.device)
        token_of_slot[slot.reshape(-1)] = torch.arange(
            t, device=xt.device).repeat_interleave(k)
        frac_routed = onehot.sum(1).to(torch.float32).mean(0)       # f_e
        aux = e * torch.sum(frac_routed * probs.mean(0))
        return Routing(top_w, top_idx, slot, token_of_slot[:n_slots], capacity, aux)

    def _experts(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.quantized:
            return int4_matmul(x, getattr(self, f"{name}_packed"),
                               getattr(self, f"{name}_scales"), self.dtype)
        return x @ getattr(self, name).to(self.dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        with torch.profiler.record_function("moe_route"):
            r = self.route(xt)
        e, c = self.n_experts, r.capacity
        zero = torch.zeros((1, d), dtype=self.dtype, device=x.device)
        with torch.profiler.record_function("moe_dispatch"):
            expert_in = torch.cat([xt.to(self.dtype), zero])[r.token_of_slot].reshape(e, c, d)
        gate = self._experts("experts_gate", expert_in)
        up = self._experts("experts_up", expert_in)
        expert_out = self._experts("experts_down", F.silu(gate) * up)
        with torch.profiler.record_function("moe_dispatch"):
            out_flat = torch.cat([expert_out.reshape(e * c, d), zero])
            gathered = out_flat[r.slot]                             # (T, k, d)
            out = (r.top_w.to(self.dtype)[..., None] * gathered).sum(1)
        return out.reshape(b, s, d).to(x.dtype), r.aux
