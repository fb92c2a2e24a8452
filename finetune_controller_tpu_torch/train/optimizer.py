"""Optimizer and LR schedule (counterpart of ``train/optimizer.py``), matched
to the reference's optax chain step for step:

* the schedule is ``join_schedules`` of ``linear_schedule(0, lr,
  max(warmup, 1))`` and a cosine / linear / constant decay to
  ``min_lr_ratio · lr`` over ``max(total - warmup, 1)`` steps;
* the update is ``chain(clip_by_global_norm(clip), adamw(schedule, b1, b2,
  eps=1e-8, weight_decay))``: the clip has no ``+1e-6`` (unlike
  ``torch.nn.utils.clip_grad_norm_``), Adam's bias correction counts from 1,
  decay applies to every trainable leaf, and the learning rate of update n
  (counting from 0) is ``schedule(n)`` — 0 for the first update under warmup.

Written as plain tensor code over the trainable leaves; ``torch.optim.AdamW``
differs in where eps and the decay enter.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax's ``linear_schedule``: init -> end over ``transition_steps``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax's ``cosine_decay_schedule`` (exponent 1)."""

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def build_schedule(learning_rate: float, warmup_steps: int, total_steps: int,
                   schedule: str = "cosine", min_lr_ratio: float = 0.1) -> Schedule:
    warmup = linear_schedule(0.0, learning_rate, max(warmup_steps, 1))
    decay_steps = max(total_steps - warmup_steps, 1)
    if schedule == "cosine":
        decay = cosine_decay_schedule(learning_rate, decay_steps, min_lr_ratio)
    elif schedule == "linear":
        decay = linear_schedule(learning_rate, learning_rate * min_lr_ratio, decay_steps)
    elif schedule == "constant":
        def decay(count: int) -> float:
            return learning_rate
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    def joined(step: int) -> float:  # join_schedules([warmup, decay], [warmup_steps])
        return warmup(step) if step < warmup_steps else decay(step - warmup_steps)

    return joined


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    eps, weight_decay=weight_decay))`` over named f32 tensors, updated in
    place.  State: ``count`` and the first and second moments."""

    def __init__(self, params: Mapping[str, torch.Tensor], schedule: Schedule, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, clip_norm: float = 1.0):
        self.params = dict(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update from ``grads`` (name -> tensor); returns the
        global norm of ``grads`` before clipping."""
        g_norm = global_norm(grads.values())
        keep = g_norm < self.clip_norm  # stays on the device: no host sync
        count = self.count + 1
        # bias corrections as optax computes them: 1 - decay**count in f32
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        lr = float(np.float32(-self.schedule(self.count)))
        for name, p in self.params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / g_norm) * self.clip_norm)
            mu, nu = self.mu[name], self.nu[name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(lr * update)
        self.count = count
        return g_norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        for name in self.params:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])
