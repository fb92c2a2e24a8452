"""The trainer (counterpart of ``train/trainer.py``): the model on one device,
the train step with gradient accumulation, and a lean ``fit`` loop with
metrics, checkpoints, resume and preemption handling.

``TrainConfig`` is copied field for field, so one spec fits both packages.
What this slice runs: ``task="sft"``, ``mode`` ``lora`` and ``full``,
``frozen_dtype``, ``grad_accum_steps``, LoRA dropout, the remat policies of
``models/llama.py``, prefetch, checkpoints and resume.  Configurations it
cannot train raise ``NotImplementedError`` naming the ROADMAP queue; the
fields that steer TPU-only machinery (guards, heartbeat, tracing) are
accepted and have no effect here.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import LlamaConfig, LlamaForCausalLM, init_random_
from .checkpoint import CheckpointManager
from .losses import next_token_loss
from .metrics import MetricsWriter
from .optimizer import AdamW, build_schedule

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    mode: str = "lora"            # "lora" | "full"
    #: training objective: "sft" (this class) | "dpo" | "rlhf" | "reward"
    #: (the preference plane, not ported yet)
    task: str = "sft"
    dpo_beta: float = 0.1
    rollout_workers: int = 0
    learning_rate: float = 2e-4
    warmup_steps: int = 10
    total_steps: int = 100
    schedule: str = "cosine"
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    batch_size: int = 8           # global
    seq_len: int = 512
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    profile_steps: int = 0
    profile_start_step: int = 2
    pp_microbatches: int = 0
    export_merged: bool = False
    #: storage dtype of the frozen base in lora mode (e.g. "bfloat16");
    #: None keeps the model's param_dtype
    frozen_dtype: str | None = None
    eval_every: int = 0
    eval_steps: int = 8
    #: sequential microbatches per optimizer step, gradients accumulated
    grad_accum_steps: int = 1
    #: host prefetch depth (``data/prefetch.py``); 0 builds batches inline
    prefetch: int = 2
    prefetch_to_device: bool = True
    recompile_budget: int = 0
    recompile_action: str = "warn"
    transfer_guard: str = ""
    shard_audit: str = ""
    heartbeat_interval_s: float = 10.0
    trace: bool = True


def refuse_untrainable(model_cfg: LlamaConfig, cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice cannot train."""
    refusals = [
        (cfg.task != "sft", f"task {cfg.task!r}: the preference plane (ROADMAP Queue A item 6)"),
        (bool(model_cfg.n_experts), "MoE configs (ROADMAP Queue A item 5)"),
        (model_cfg.quantize_base, "int4 QLoRA bases (ROADMAP Queue A item 5)"),
        (cfg.eval_every > 0, "eval_every > 0: held-out evaluation (ROADMAP Queue A item 3)"),
        (cfg.profile_steps > 0, "profile_steps > 0: profiler windows (ROADMAP Queue A item 3)"),
        (cfg.export_merged, "export_merged: HF/PEFT export (ROADMAP Queue A item 3)"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"the port's trainer does not run {what} yet")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


class PreemptionGuard:
    """SIGTERM -> save-and-exit flag; restores the previous handler."""

    def __init__(self):
        self.requested = False
        self._previous = None

    def install(self) -> None:
        def handler(signum, frame):
            logger.warning("preemption signal %s received; will checkpoint and exit", signum)
            self.requested = True

        self._previous = signal.signal(signal.SIGTERM, handler)

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None


class Trainer:
    """One model on one device (``cuda`` unless ``device="cpu"``).

    In lora mode the adapters are trained in ``model_cfg.param_dtype`` and
    the base is stored in ``frozen_dtype`` (or ``param_dtype``); in full
    mode every parameter is trained.  Parameters start from ``seed``
    (:func:`~..models.llama.init_random_`); load other weights with
    ``trainer.model.load_state_dict`` before the first step."""

    def __init__(self, model_cfg: LlamaConfig, train_cfg: TrainConfig, device=None):
        refuse_untrainable(model_cfg, train_cfg)
        self.cfg = train_cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        if train_cfg.seq_len > model_cfg.max_seq_len:
            logger.warning(
                "seq_len %d exceeds the model's max_seq_len %d: RoPE positions run "
                "beyond the preset's trained range", train_cfg.seq_len, model_cfg.max_seq_len,
            )
        accum = train_cfg.grad_accum_steps
        if accum > 1 and train_cfg.batch_size % accum:
            raise ValueError(f"batch_size {train_cfg.batch_size} not divisible by "
                             f"grad_accum_steps {accum}")
        if train_cfg.mode not in ("lora", "full"):
            raise ValueError(f"unknown training mode {train_cfg.mode!r}")
        lora = train_cfg.mode == "lora"
        if lora and model_cfg.lora.rank <= 0:
            raise ValueError("mode='lora' but the model has no LoRA params; set lora.rank > 0")
        # the frozen base is created in its storage dtype (no f32 copy of an
        # 8B base on the card), the trained leaves in param_dtype
        frozen_dtype = (_torch_dtype(train_cfg.frozen_dtype)
                        if lora and train_cfg.frozen_dtype else model_cfg.param_dtype)
        self.model = LlamaForCausalLM(model_cfg.replace(param_dtype=frozen_dtype),
                                      device=self.device)
        self.trainable: dict[str, torch.nn.Parameter] = {}
        for name, p in self.model.named_parameters():
            train = not lora or name.endswith((".lora_a", ".lora_b"))
            if train:
                p.data = p.data.to(model_cfg.param_dtype)
                self.trainable[name] = p
            p.requires_grad_(train)
        init_random_(self.model, train_cfg.seed)
        self.sched = build_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                                    train_cfg.total_steps, train_cfg.schedule)
        self.optimizer = AdamW(self.trainable, self.sched, weight_decay=train_cfg.weight_decay,
                               clip_norm=train_cfg.clip_norm)
        self.step_count = 0

    # ---- the step ----------------------------------------------------------

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for key, x in batch.items():
            x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            if key in ("tokens", "segment_ids"):
                x = x.to(torch.int64 if key == "tokens" else torch.int32)
            out[key] = x.to(self.device, non_blocking=True)
        return out

    def step(self, batch: dict) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (numpy or tensors: ``tokens``,
        optional ``loss_mask`` and ``segment_ids``).  Each of the
        ``grad_accum_steps`` microbatches contributes its mean loss's
        gradient; the gradients and the metrics are averaged over them,
        ``target_tokens`` summed.  Returns 0-dim tensors: loss, accuracy,
        target_tokens, grad_norm (before clipping) and learning_rate."""
        batch = self._to_device(batch)
        accum = self.cfg.grad_accum_steps
        rows = batch["tokens"].shape[0] // accum
        self.model.train()
        sums: dict[str, torch.Tensor] = {}
        for i in range(accum):
            micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            if self.model_cfg.lora.dropout > 0:
                self.model.set_dropout_seed(
                    (self.cfg.seed * 1_000_003 + self.step_count) * 1_009 + i)
            logits = self.model(micro["tokens"], segment_ids=micro.get("segment_ids"))
            loss, aux = next_token_loss(logits, micro["tokens"], micro.get("loss_mask"))
            del logits
            loss.backward()
            for k, v in aux.items():
                sums[k] = sums[k] + v if k in sums else v
        inv = 1.0 / accum
        grads = {}
        for name, p in self.trainable.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g * inv if accum > 1 else g
        metrics = {k: (v if k == "target_tokens" or accum == 1 else v * inv)
                   for k, v in sums.items()}
        metrics["grad_norm"] = self.optimizer.step(grads)
        metrics["learning_rate"] = torch.tensor(self.sched(self.step_count))
        for p in self.trainable.values():
            p.grad = None
        self.step_count += 1
        return metrics

    # ---- state -------------------------------------------------------------

    def state_dict(self) -> dict[str, Any]:
        """What a checkpoint holds: the step, the trained tensors and the
        optimizer state, on the CPU."""
        opt = self.optimizer.state_dict()
        cpu = lambda d: {k: v.detach().to("cpu") for k, v in d.items()}  # noqa: E731
        return {"step": self.step_count,
                "trainable": cpu(self.trainable),
                "opt_state": {"count": opt["count"], "mu": cpu(opt["mu"]),
                              "nu": cpu(opt["nu"])}}

    @torch.no_grad()
    def load_state(self, state: dict[str, Any]) -> None:
        for name, p in self.trainable.items():
            p.copy_(state["trainable"][name])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step_count = int(state["step"])

    # ---- the loop ----------------------------------------------------------

    def fit(self, batches: Iterable[dict], artifacts_dir: str, resume: bool = True,
            on_metrics: Callable[[int, dict], None] | None = None) -> None:
        """Train from the latest checkpoint (or the start) to
        ``total_steps``: a ``metrics.csv`` row every ``log_every`` steps and
        at the last, a checkpoint every ``checkpoint_every`` steps and at
        the last; SIGTERM checkpoints and exits with ``SystemExit(143)``."""
        logger.info("this slice of the port writes no lifecycle events, spans, heartbeat, "
                    "phase clock or PEFT export (ROADMAP Queue A item 3)")
        cfg = self.cfg
        guard = PreemptionGuard()
        try:
            guard.install()
        except ValueError:
            pass  # not on the main thread (e.g. tests)
        ckpt = CheckpointManager(f"{artifacts_dir}/checkpoints", keep=cfg.keep_checkpoints)
        start_step = 0
        latest = ckpt.latest_step() if resume else None
        if latest is not None:
            self.load_state(ckpt.restore(latest))
            start_step = latest
            logger.info("resumed from checkpoint step %d", start_step)
        writer = MetricsWriter(artifacts_dir, append=start_step > 0,
                               extra_fields=("input_ms", "input_fraction"),
                               resume_step=start_step)
        it: Iterator[dict] = iter(batches)
        # the same data stream an uninterrupted run would have seen
        for _ in range(start_step):
            next(it)
        prefetch = None
        if cfg.prefetch > 0:
            from ..data.prefetch import PrefetchIterator

            it = prefetch = PrefetchIterator(it, depth=cfg.prefetch)
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        window_t0, window_tokens, window_input_s, window_steps = time.perf_counter(), 0, 0.0, 0
        try:
            for step_idx in range(start_step, cfg.total_steps):
                t_in = time.perf_counter()
                batch = next(it)
                window_input_s += time.perf_counter() - t_in
                window_steps += 1
                metrics = self.step(batch)
                window_tokens += tokens_per_batch
                last = step_idx + 1 == cfg.total_steps
                if (step_idx + 1) % cfg.log_every == 0 or last:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    dt = time.perf_counter() - window_t0
                    metrics["tokens_per_sec"] = window_tokens / max(dt, 1e-9)
                    metrics["input_ms"] = window_input_s / max(window_steps, 1) * 1000.0
                    metrics["input_fraction"] = window_input_s / max(dt, 1e-9)
                    writer.write({"step": step_idx + 1, **metrics})
                    if on_metrics:
                        on_metrics(step_idx + 1, metrics)
                    logger.info("step %d loss %.4f acc %.3f tok/s %.0f input %.1fms"
                                " (%.1f%% of step)", step_idx + 1, metrics["loss"],
                                metrics["accuracy"], metrics["tokens_per_sec"],
                                metrics["input_ms"], 100.0 * metrics["input_fraction"])
                    window_t0, window_tokens, window_input_s, window_steps = (
                        time.perf_counter(), 0, 0.0, 0)
                preempt = guard.requested
                if (step_idx + 1) % cfg.checkpoint_every == 0 or last or preempt:
                    ckpt.save(step_idx + 1, self.state_dict())
                if preempt:
                    logger.warning("exiting on preemption after step %d", step_idx + 1)
                    raise SystemExit(143)
        finally:
            if prefetch is not None:
                prefetch.close()
            writer.close()
            guard.uninstall()
