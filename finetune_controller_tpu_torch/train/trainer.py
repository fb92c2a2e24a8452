"""The trainer (counterpart of ``train/trainer.py``): the model on one device,
the train step with gradient accumulation, held-out evaluation, and ``fit``
with metrics, checkpoints, resume, preemption handling and the reference's
observability.

``TrainConfig`` is copied field for field, so one spec fits both packages.
What this slice runs: ``task="sft"``, ``mode`` ``lora`` and ``full``,
``frozen_dtype``, ``grad_accum_steps``, LoRA dropout, the remat policies of
``models/llama.py``, int4 QLoRA bases (``quantize_base``: the kernels are
drawn or loaded, then quantized on the device one tensor at a time), MoE
models (the objective adds ``router_aux_weight`` times the layers'
load-balancing terms, logged as ``moe_aux``), prefetch (with the copy to
the card on the producer thread when ``prefetch_to_device``), pretrained
HF weights (:meth:`Trainer.load_pretrained`), evaluation every
``eval_every`` steps,
the PEFT adapter and merged HF exports (:meth:`Trainer.export_artifacts`),
LLaVA models (``models/multimodal.py``, selected by the config's type:
``pixels`` ride in every batch, the projector trains beside the adapters
while the vision tower stays frozen),
and, as the reference writes them, ``heartbeat.json``, ``events.jsonl``,
``trace/trainer.jsonl`` and the ``phase_*_ms`` columns.  A profiler window
(``profile_steps`` from ``profile_start_step``, or one requested on a live
job through ``profile_request.json``) writes a ``torch.profiler`` Chrome
trace under ``profile/``.

Checkpoints follow the reference's contract (``train/checkpoint.py``):
mid-run saves are asynchronous (the state is copied to the host and the
copy synchronized before a writer thread serializes it), the last save and
a preemption save block, every save carries the topology manifest
(``train/elastic.py``), and a resume restores through the shape-checked
``restore(like=)``, from the port's checkpoints or the JAX package's
(``state.msgpack``, or orbax's OCDBT layout).  ``fit`` arms the chaos hook of
``resilience/faults.py`` (``FTC_FAULT_KILL_AT_STEP``, ``FTC_FAULT_SIGNAL``,
``FTC_FAULT_ONCE_FILE``).

The objective is a hook, as in the reference: :meth:`Trainer._loss` (one
microbatch's loss and metrics), :meth:`Trainer._eval_metrics`,
:meth:`Trainer._writer_extra_fields` and :meth:`Trainer._row_extras` (merged
into every metrics row), and ``_extra_trainable`` (leaves trained beside the
model's); the preference trainers (``prefs/``) override them.  A batch is
split into microbatches by the rows of its first leaf, so a pair batch
splits pair-wise.

The step and eval calls run behind the reference's runtime guards
(``analysis/``): ``recompile_budget`` above 0 counts their distinct call
signatures (``recompile_action`` warns or raises past it), and
``transfer_guard`` (or ``FTC_TRANSFER_GUARD`` when it is empty) makes a
device<->host sync inside the step a ``TransferGuardError``; the step's copy
of the batch to the device runs before the guarded window.  ``shard_audit``
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import logging
import signal
import sys
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import LlamaConfig, LlamaForCausalLM, init_random_
from ..models.multimodal import LlavaConfig, LlavaForCausalLM
from .checkpoint import CheckpointManager
from .elastic import (
    RULE_FINGERPRINT,
    SINGLE_DEVICE_AXES,
    build_manifest,
    check_fingerprint,
    check_single_device_resume,
)
from .losses import next_token_loss
from .metrics import MetricsWriter
from .optimizer import AdamW, build_schedule

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    mode: str = "lora"            # "lora" | "full"
    #: training objective: "sft" (this class) | "dpo" | "rlhf" | "reward"
    #: (the preference trainers of ``prefs/``)
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
    #: None keeps the model's param_dtype.  Int4 kernels and their bf16
    #: scales are left as they are
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
    """Raise ``NotImplementedError`` for what the port cannot train yet: the
    shard audit (ROADMAP Queue A item 9), which needs the DTensor placements
    of item 7."""
    if cfg.shard_audit:
        raise NotImplementedError(
            f"the port's trainer does not run shard_audit {cfg.shard_audit!r}: "
            "the shard audit (ROADMAP Queue A item 9) is not ported yet")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


class ProfileWindow:
    """A ``torch.profiler`` window over training steps, written as a Chrome
    trace under ``{artifacts_dir}/profile/`` (the reference opens a
    ``jax.profiler`` window there).  Device activity is traced when the
    trainer runs on a CUDA card."""

    def __init__(self, artifacts_dir: str, device: torch.device):
        self.dir = os.path.join(artifacts_dir, "profile")
        self.device = device
        self._prof = None
        self.first_step = 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self.first_step = step

    def stop(self, step: int) -> str:
        """End the window after ``step`` (exclusive end) and write its trace;
        returns the trace's path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"steps_{self.first_step}-{step}.pt.trace.json")
        prof.export_chrome_trace(path)
        return path


def consume_profile_request(path: str) -> int:
    """Read and retire an on-demand profiler request delivered through the
    artifact channel (``POST /jobs/{id}/profile`` → ``backend.deliver_file``
    → ``profile_request.json``): the requested step count, 0 when the file
    is unreadable.  The file is renamed either way so a bad payload cannot
    re-trigger every step (the reference's ``_consume_profile_request``)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        steps = max(1, min(int(doc.get("steps", 5)), 1000))
    except (OSError, ValueError, TypeError):
        steps = 0
    try:
        os.replace(path, path + ".consumed")
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
    return steps


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

    In lora mode the adapters (and a multimodal model's projector, which
    the LLaVA recipe always trains) are trained in ``model_cfg.param_dtype``
    and the base (a multimodal model's vision tower included) is stored in
    ``frozen_dtype`` (or ``param_dtype``); in full mode every parameter is
    trained.  Parameters start from ``seed``
    (:func:`~..models.llama.init_random_`); :meth:`load_pretrained` (or
    ``fit(pretrained_dir=...)``) replaces the base with an HF checkpoint."""

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
        if not lora and model_cfg.quantize_base:
            raise ValueError("mode='full' cannot train an int4-quantized base; "
                             "use mode='lora' (QLoRA)")
        # the frozen base is created in its storage dtype (no f32 copy of an
        # 8B base on the card), the trained leaves in param_dtype
        frozen_dtype = (_torch_dtype(train_cfg.frozen_dtype)
                        if lora and train_cfg.frozen_dtype else model_cfg.param_dtype)
        # the model family follows the config's type (the duck-type surface
        # the multimodal config mirrors)
        self.multimodal = isinstance(model_cfg, LlavaConfig)
        if self.multimodal:
            frozen_cfg = model_cfg.replace(
                param_dtype=frozen_dtype,
                vision=model_cfg.vision.replace(param_dtype=frozen_dtype))
            self.model = LlavaForCausalLM(frozen_cfg, device=self.device)
        else:
            self.model = LlamaForCausalLM(model_cfg.replace(param_dtype=frozen_dtype),
                                          device=self.device)
        self.trainable: dict[str, torch.nn.Parameter] = {}
        for name, p in self.model.named_parameters():
            train = not lora or name.endswith((".lora_a", ".lora_b")) or (
                self.multimodal and name.startswith(self.MM_TRAINED_PARAMS))
            if train:
                p.data = p.data.to(model_cfg.param_dtype)
                self.trainable[name] = p
            p.requires_grad_(train)
        init_random_(self.model, train_cfg.seed)
        self.trainable.update(self._extra_trainable())
        self.sched = build_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                                    train_cfg.total_steps, train_cfg.schedule)
        self.optimizer = AdamW(self.trainable, self.sched, weight_decay=train_cfg.weight_decay,
                               clip_norm=train_cfg.clip_norm)
        self.step_count = 0
        #: the running fit's heartbeat, so a long evaluate() beats too
        self._heartbeat = None
        self._warned_eval_unsplit = False
        #: pinned host buffers of the checkpoint snapshots on a card
        self._snapshot_buffers: dict = {}
        # the guarded step and eval callables, one per batch structure (the
        # reference's per-structure step jits)
        self._step_fns: dict[tuple[str, ...], Callable] = {}
        self._recompile_guard = None
        if train_cfg.recompile_budget > 0:
            from ..analysis.recompile_guard import RecompileGuard

            self._recompile_guard = RecompileGuard(
                train_cfg.recompile_budget, on_excess=train_cfg.recompile_action,
                name="trainer-recompile-guard",
            )
        # a prefetch thread that copies batches to the card syncs its own
        # stream, so the step's window may not arm the process-wide CUDA
        # sync-debug mode beside it (analysis/transfer_guard.py)
        from ..analysis.transfer_guard import TransferGuard

        one_driver = not (train_cfg.prefetch > 0 and train_cfg.prefetch_to_device)
        mode = (train_cfg.transfer_guard or "").strip().lower()
        self._transfer_guard = (
            TransferGuard(mode, name="trainer-transfer-guard", arm_cuda=one_driver)
            if mode in ("raise", "warn")
            # empty inherits FTC_TRANSFER_GUARD; any other value is off
            else TransferGuard.from_env(name="trainer-transfer-guard", arm_cuda=one_driver)
            if mode == "" else None
        )

    #: a multimodal model's leaves trained beside the adapters (the LLaVA
    #: recipe always trains the vision→text projector)
    MM_TRAINED_PARAMS = ("projector_fc1.", "projector_fc2.")

    #: commit every checkpoint before the next step (the reference's flag,
    #: which its in-process rlhf learner sets); mid-run saves are otherwise
    #: asynchronous, and the last save and a preemption save block
    _blocking_checkpoints = False

    def _extra_trainable(self) -> dict[str, torch.nn.Parameter]:
        """Trained leaves outside the model (their checkpoint names as
        keys), created on the trainer's device; none here."""
        return {}

    # ---- batches -----------------------------------------------------------

    @staticmethod
    def _host_batch(batch: dict) -> dict[str, torch.Tensor]:
        """``batch`` as tensors in the step's dtypes (numpy leaves wrapped,
        device tensors left where they are)."""
        out = {}
        for key, x in batch.items():
            x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            if key in ("tokens", "segment_ids"):
                x = x.to(torch.int64 if key == "tokens" else torch.int32)
            out[key] = x
        return out

    def _to_device(self, batch: dict) -> dict:
        """The step's copy of a batch to the device, on the step's thread
        (a batch the prefetch stage already moved is used as it is)."""
        out = {}
        for key, x in self._host_batch(batch).items():
            if x.device == self.device and x.is_cuda:
                # allocated on the prefetch stream: keep the block from being
                # reused while this stream's kernels may still read it
                x.record_stream(torch.cuda.current_stream(self.device))
            out[key] = x.to(self.device, non_blocking=True)
        return out

    def _transfer_stage(self) -> Callable[[dict], dict]:
        """``prefetch_to_device``: the copy to the device, run on the prefetch
        producer thread.  On a card the batch goes through pinned host
        memory to the device on a side stream, which the producer
        synchronizes before it queues the batch, so the step never reads a
        half-copied batch and its own stream never waits; on the CPU it is
        the plain ``.to(device)``."""
        if self.device.type != "cuda":
            return lambda batch: {k: v.to(self.device)
                                  for k, v in self._host_batch(batch).items()}
        stream = torch.cuda.Stream(self.device)

        def transfer(batch: dict) -> dict:
            host = self._host_batch(batch)
            with torch.cuda.stream(stream):
                out = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
            stream.synchronize()
            return out

        return transfer

    # ---- the step ----------------------------------------------------------

    def _logits(self, batch: dict, **kw):
        """The model's forward on a (micro)batch: ``pixels`` go to a
        multimodal model."""
        if self.multimodal:
            kw["pixels"] = batch.get("pixels")
        return self.model(batch["tokens"], segment_ids=batch.get("segment_ids"), **kw)

    def _loss(self, micro: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """One microbatch's objective (the reference's ``_loss_fn``): the
        loss to differentiate and its detached metrics.  Here the masked
        next-token cross-entropy, plus for an MoE model the weighted
        load-balancing term (logged as ``moe_aux``; the ``loss`` column stays
        the cross-entropy)."""
        moe = bool(self.model_cfg.n_experts)
        logits = self._logits(micro, return_moe_aux=moe)
        if moe:
            logits, moe_aux = logits
        loss, aux = next_token_loss(logits, micro["tokens"], micro.get("loss_mask"))
        del logits
        if moe:
            penalty = self.model_cfg.router_aux_weight * moe_aux
            loss = loss + penalty
            aux = dict(aux, moe_aux=penalty.detach())
        return loss, aux

    def _eval_metrics(self, batch: dict) -> dict[str, torch.Tensor]:
        """Forward-only metrics of one held-out (micro)batch (the
        reference's ``_eval_step``), called under ``no_grad`` in eval mode."""
        logits = self._logits(batch)
        return next_token_loss(logits, batch["tokens"], batch.get("loss_mask"))[1]

    def step(self, batch: dict) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (numpy or tensors: ``tokens``,
        optional ``loss_mask`` and ``segment_ids``, and a multimodal
        model's ``pixels`` (B, H, W, 3); a preference trainer's pair
        leaves).  The batch splits into ``grad_accum_steps`` microbatches by
        the rows of its first leaf, every leaf alike; each microbatch
        contributes the gradient of :meth:`_loss`, and the gradients and the
        metrics are averaged over them, ``target_tokens`` summed.  Returns
        0-dim tensors: the objective's metrics (here loss, accuracy,
        target_tokens, and for an MoE model ``moe_aux``), grad_norm (before
        clipping) and learning_rate.  The copy to the device runs first;
        the rest is the guarded window of ``recompile_budget`` and
        ``transfer_guard``."""
        batch = self._to_device(batch)
        return self._guarded("step", self._device_step, batch)(batch)

    def _guarded(self, kind: str, fn: Callable, batch: dict) -> Callable:
        """``fn`` behind the guards, cached per batch structure and labelled
        as the reference labels its jits (``step:loss_mask,tokens``,
        ``eval:eval,tokens``); the eval calls take no transfer guard, as in
        the reference."""
        key = tuple(sorted(batch)) if kind == "step" else ("eval",) + tuple(sorted(batch))
        guarded = self._step_fns.get(key)
        if guarded is None:
            guarded = fn
            label = f"{kind}:{','.join(key)}"
            if self._recompile_guard is not None:
                guarded = self._recompile_guard.wrap(guarded, label=label)
            if self._transfer_guard is not None and kind == "step":
                guarded = self._transfer_guard.wrap(guarded, label=label)
            self._step_fns[key] = guarded
        return guarded

    def _device_step(self, batch: dict) -> dict[str, torch.Tensor]:
        """:meth:`step` on a batch already on the device: no host sync."""
        accum = self.cfg.grad_accum_steps
        rows = next(iter(batch.values())).shape[0] // accum
        self.model.train()
        sums: dict[str, torch.Tensor] = {}
        for i in range(accum):
            micro = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            if self.model_cfg.lora.dropout > 0:
                self.model.set_dropout_seed(
                    (self.cfg.seed * 1_000_003 + self.step_count) * 1_009 + i)
            loss, aux = self._loss(micro)
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

    @torch.no_grad()
    def evaluate(self, eval_batches: Iterator[dict]) -> dict[str, float]:
        """Average forward-only metrics over ``cfg.eval_steps`` batches
        (the reference's ``evaluate``): no gradients, dropout off, each
        batch split into ``grad_accum_steps`` microbatches as the step
        splits it; the model is back in train mode after.  Returns
        :meth:`_eval_metrics`'s keys prefixed ``eval_`` (``eval_loss``,
        ``eval_accuracy``) and ``eval_input_ms`` (host build + transfer time
        per eval batch).  The pass is the profiler range ``evaluate``."""
        sums: dict[str, float] = {}
        n = 0
        n_batches = max(1, self.cfg.eval_steps)
        input_s = 0.0
        self.model.eval()
        try:
            with torch.profiler.record_function("evaluate"):
                for _ in range(n_batches):
                    t_in = time.perf_counter()
                    host_batch = next(eval_batches)
                    input_s += time.perf_counter() - t_in
                    # grad accumulation exists because the full batch's
                    # activations don't fit the card — eval microbatches the same way
                    accum = self.cfg.grad_accum_steps
                    rows = next(iter(host_batch.values())).shape[0]
                    chunks = accum if accum > 1 and rows % accum == 0 else 1
                    if accum > 1 and chunks == 1 and not self._warned_eval_unsplit:
                        self._warned_eval_unsplit = True
                        logger.warning(
                            "eval batch rows (%d) not divisible by grad_accum_steps (%d): "
                            "evaluating UNSPLIT", rows, accum)
                    size = rows // chunks
                    for c in range(chunks):
                        t_in = time.perf_counter()
                        batch = self._to_device(
                            {k: v[c * size:(c + 1) * size] for k, v in host_batch.items()})
                        input_s += time.perf_counter() - t_in
                        eval_fn = self._guarded("eval", self._eval_metrics, batch)
                        for k, v in eval_fn(batch).items():
                            sums[k] = sums.get(k, 0.0) + float(v)
                        n += 1
                    if self._heartbeat is not None:
                        # liveness through a long eval pass (float() above synced)
                        self._heartbeat.beat(self.step_count)
        finally:
            self.model.train()
        # target_tokens is a per-batch count: averaging it is meaningless
        out = {f"eval_{k}": v / n for k, v in sums.items() if k != "target_tokens"}
        out["eval_input_ms"] = input_s / n_batches * 1000.0
        return out

    # ---- weights in and out ------------------------------------------------

    def load_pretrained(self, ckpt_dir: str) -> None:
        """Replace the base weights with an HF checkpoint
        (``models/hf_import.load_pretrained_``), in place: in lora mode
        the frozen base, in full mode the trained tensors themselves, so
        the optimizer's references stay valid; a kernel the model stores as
        int4 is quantized on the device as it arrives, one tensor at a time.
        A LLaVA checkpoint fills the decoder and the tower (frozen) and the
        projector, in place in the trained set.  Call it before the first
        step."""
        from ..models.hf_import import load_pretrained_

        load_pretrained_(self.model, ckpt_dir)

    def export_artifacts(self, artifacts_dir: str) -> None:
        """Deployable HF-format artifacts after training (the reference's
        single-process branch): a PEFT ``adapter/`` for every LoRA run, and
        ``merged/`` (the adapters folded into the base, f32) when
        ``cfg.export_merged``.  A full fine-tune exports nothing here, as in
        the reference.  A multimodal run exports the decoder's adapter under
        HF LLaVA's ``language_model`` prefix and the trained projector
        (``adapter/projector.safetensors``); no merged form exists for it."""
        if self.cfg.mode != "lora":
            return
        from ..models.hf_export import (
            export_lora_adapter,
            export_merged_checkpoint,
            export_mm_projector,
        )

        state = {k: v.detach() for k, v in self.model.state_dict().items()}
        if self.multimodal:
            export_lora_adapter(self.model_cfg.text, state, f"{artifacts_dir}/adapter",
                                hf_prefix="base_model.model.language_model.model.layers")
            export_mm_projector(state, f"{artifacts_dir}/adapter")
            if self.cfg.export_merged:
                logger.warning(
                    "export_merged skipped: multimodal runs export the "
                    "adapter + projector (no single-file HF merge exists)"
                )
            return
        export_lora_adapter(self.model_cfg, state, f"{artifacts_dir}/adapter")
        if self.cfg.export_merged:
            try:
                export_merged_checkpoint(self.model_cfg, state, f"{artifacts_dir}/merged")
            except NotImplementedError as exc:
                # an unsupported merged layout (partial Gemma semantics) must
                # not fail a completed run — the adapter already shipped
                logger.warning("export_merged skipped: %s", exc)

    # ---- state -------------------------------------------------------------

    def _state_tree(self) -> dict[str, Any]:
        """The live state as a checkpoint lays it out (device tensors, not
        copied): the template a restore is shape-checked against."""
        opt = self.optimizer.state_dict()
        return {"step": self.step_count, "trainable": dict(self.trainable),
                "opt_state": {"count": opt["count"], "mu": opt["mu"], "nu": opt["nu"]}}

    def state_dict(self) -> dict[str, Any]:
        """What a checkpoint holds: the step, the trained tensors and the
        optimizer state, as a snapshot on the CPU that later steps do not
        touch (fresh tensors, copied synchronously from a card)."""
        return self._host_state(None)

    def _host_state(self, buffers: dict | None) -> dict[str, Any]:
        """:meth:`state_dict`'s snapshot, into ``buffers`` when given: pinned
        host tensors by leaf, allocated at the first call and overwritten by
        each later one.  The pinned copies are issued without blocking and
        the device is synchronized before returning, so a writer thread that
        serializes the snapshot reads landed bytes."""
        tree = self._state_tree()

        def host(part, d):
            if buffers is None:
                return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
            out = {}
            for k, v in d.items():
                buf = buffers.get((part, k))
                if buf is None:
                    buf = buffers[(part, k)] = torch.empty(v.shape, dtype=v.dtype,
                                                           pin_memory=True)
                out[k] = buf.copy_(v.detach(), non_blocking=True)
            return out

        out = {"step": tree["step"], "trainable": host("trainable", tree["trainable"]),
               "opt_state": {"count": tree["opt_state"]["count"],
                             "mu": host("mu", tree["opt_state"]["mu"]),
                             "nu": host("nu", tree["opt_state"]["nu"])}}
        if buffers is not None:
            torch.cuda.synchronize(self.device)
        return out

    def _checkpoint_state(self, ckpt: CheckpointManager) -> dict[str, Any]:
        """The state a save hands to the checkpoint writer.  On a card it is
        copied into pinned buffers the trainer keeps across saves (fresh
        pinned or pageable buffers cost many times the copy itself: phase
        R2 of ``chip_smoke.py`` times the three), so the save in flight,
        whose writer reads those buffers, is waited for first."""
        if self.device.type != "cuda":
            return self.state_dict()
        ckpt.wait()
        return self._host_state(self._snapshot_buffers)

    @torch.no_grad()
    def load_state(self, state: dict[str, Any]) -> None:
        """Copy a checkpoint's state in, after checking every leaf's name and
        shape against the live state (``CheckpointShapeError`` names the
        first mismatch; ``copy_`` alone would broadcast a ``(1, n)`` tensor
        into an ``(m, n)`` parameter)."""
        CheckpointManager._validate_like("", state, self._state_tree())
        for name, p in self.trainable.items():
            p.copy_(state["trainable"][name])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step_count = int(state["step"])

    def _kernel_launches(self) -> dict[str, int] | None:
        """The flash kernels' launches in this process so far (each
        wrapper's count), carried by the checkpoint and finish events so a
        run in a subprocess shows which kernels its steps ran; None off a
        card, where the wrappers run their plain versions."""
        if self.device.type != "cuda":
            return None
        from ..ops.kernels import flash_attention as fa

        return {name: getattr(fa, name).launches
                for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv")}

    def _build_manifest(self, step: int, host_state: dict) -> dict:
        """The topology manifest of a checkpoint (``train/elastic.py``): one
        card, the port's rule fingerprint, the batch decomposition."""
        return build_manifest(
            step=step, mesh_axes=SINGLE_DEVICE_AXES, rule_fingerprint=RULE_FINGERPRINT,
            global_batch_size=self.cfg.batch_size, grad_accum_steps=self.cfg.grad_accum_steps,
            seq_len=self.cfg.seq_len, seed=self.cfg.seed, host_tree=host_state)

    def _restore(self, ckpt: CheckpointManager, step: int) -> None:
        """Resume from ``step``: the manifest's fingerprint (the port's own
        checkpoints; a JAX-written state is whole arrays, which no rule table
        shards on one card) and batch decomposition, then the shape-checked
        restore."""
        layout = ckpt.layout(step)
        manifest = ckpt.load_manifest(step)
        if manifest is not None:
            if layout == "torch":
                check_fingerprint(manifest, RULE_FINGERPRINT)
            check_single_device_resume(manifest, batch_size=self.cfg.batch_size,
                                       grad_accum_steps=self.cfg.grad_accum_steps)
        self.load_state(ckpt.restore(step, like=self._state_tree()))

    def _writer_extra_fields(self, eval_enabled: bool) -> tuple[str, ...]:
        """Metrics-CSV columns that may appear only on later rows and must
        be declared up front (``MetricsWriter`` pins the header)."""
        fields: tuple[str, ...] = ("input_ms", "input_fraction")
        if eval_enabled:
            fields += ("eval_loss", "eval_accuracy", "eval_input_ms")
        return fields

    def _row_extras(self) -> dict:
        """Host-side metrics merged into every metrics row (the rlhf
        learner's rollout columns); none here."""
        return {}

    # ---- the loop ----------------------------------------------------------

    def fit(self, batches: Iterable[dict], artifacts_dir: str, resume: bool = True,
            on_metrics: Callable[[int, dict], None] | None = None,
            pretrained_dir: str | None = None,
            eval_batches: Iterable[dict] | None = None) -> None:
        """Train from the latest checkpoint (or the start) to
        ``total_steps``: a ``metrics.csv`` row every ``log_every`` steps, at
        eval steps and at the last; an evaluation every ``eval_every`` steps
        and at the last; a checkpoint every ``checkpoint_every`` steps and
        at the last (mid-run saves asynchronous; ``fit`` returns or raises
        only after every save committed); SIGTERM checkpoints and exits with
        ``SystemExit(143)``; ``FTC_FAULT_KILL_AT_STEP`` sends
        ``FTC_FAULT_SIGNAL`` to the process after that step's row.

        ``pretrained_dir`` loads an HF base before the checkpoint restore
        (a full fine-tune that resumes skips it: its checkpoint holds every
        weight).  As the reference does, ``fit`` writes ``heartbeat.json``
        (every ``heartbeat_interval_s``, if above 0), and unless ``trace``
        is off or ``FTC_TRACE=0``, ``events.jsonl``, the spans of
        ``trace/trainer.jsonl`` (under ``FTC_TRACE_ID``, or a trace id of
        its own) and the ``phase_*_ms`` columns; ``FTC_ATTEMPT`` stamps the
        attempt."""
        from ..obs.events import EventLogWriter
        from ..obs.phase import PhaseClock
        from ..obs.trace import SpanRecorder, new_trace_id
        from ..resilience.faults import StepFaultInjector
        from ..resilience.heartbeat import HeartbeatWriter

        cfg = self.cfg
        guard = PreemptionGuard()
        try:
            guard.install()
        except ValueError:
            pass  # not on the main thread (e.g. tests)
        ckpt = CheckpointManager(f"{artifacts_dir}/checkpoints", keep=cfg.keep_checkpoints)
        obs_on = cfg.trace and os.environ.get("FTC_TRACE", "1").strip().lower() not in (
            "0", "false", "no", "off")
        controller_trace_id = os.environ.get("FTC_TRACE_ID", "")
        attempt = int(os.environ.get("FTC_ATTEMPT", "1") or 1)
        events_log = EventLogWriter(artifacts_dir, trace_id=controller_trace_id,
                                    attempt=attempt, enabled=obs_on)
        # without a controller's trace id the spans carry one of their own
        spans = SpanRecorder(artifacts_dir, controller_trace_id or new_trace_id(),
                             attempt=attempt, enabled=obs_on)
        phases = PhaseClock()
        fit_span = spans.start("fit", total_steps=cfg.total_steps)
        latest = ckpt.latest_step() if resume else None
        with spans.span("init", parent=fit_span, pretrained=bool(pretrained_dir) or None):
            if pretrained_dir and not (latest is not None and cfg.mode == "full"):
                # the base before the restore, which replaces only the
                # trained tensors: in lora mode the base comes from here on
                # every resume too
                self.load_pretrained(pretrained_dir)
        start_step = 0
        if latest is not None:
            restore_span = spans.start("restore", parent=fit_span, step=latest)
            self._restore(ckpt, latest)
            start_step = self.step_count
            spans.finish(restore_span, step=start_step)
            logger.info("resumed from checkpoint step %d", start_step)
        heartbeat = None
        if cfg.heartbeat_interval_s > 0:
            heartbeat = HeartbeatWriter(artifacts_dir, interval_s=cfg.heartbeat_interval_s)
            heartbeat.beat(start_step, force=True)
        self._heartbeat = heartbeat
        events_log.emit("train-started", step=start_step,
                        resumed_from=start_step if start_step else None)
        # chaos hook (resilience/faults.py): a kill-at-step armed through
        # FTC_FAULT_*; None outside fault-injection runs
        fault = StepFaultInjector.from_env()
        eval_it: Iterator[dict] | None = iter(eval_batches) if eval_batches is not None else None
        if cfg.eval_every > 0 and eval_it is None:
            raise ValueError("eval_every > 0 but no eval_batches were supplied to fit()")
        writer = MetricsWriter(
            artifacts_dir, append=start_step > 0,
            extra_fields=self._writer_extra_fields(eval_it is not None)
            + (PhaseClock.columns() if obs_on else ()),
            resume_step=start_step)
        it: Iterator[dict] = iter(batches)
        # the same data stream an uninterrupted run would have seen
        for _ in range(start_step):
            next(it)
        prefetch_its = []
        if cfg.prefetch > 0:
            from ..data.prefetch import PrefetchIterator

            it = PrefetchIterator(
                it, depth=cfg.prefetch,
                transfer=self._transfer_stage() if cfg.prefetch_to_device else None)
            prefetch_its.append(it)
            if eval_it is not None and cfg.eval_every > 0:
                eval_it = PrefetchIterator(eval_it, depth=1)
                prefetch_its.append(eval_it)
        tokens_per_batch = cfg.batch_size * cfg.seq_len
        window_t0, window_tokens, window_input_s, window_steps = time.perf_counter(), 0, 0.0, 0
        # the profiler window, as the reference places it: the configured
        # one from profile_start_step (clamped into the run), and on-demand
        # ones from profile_request.json, polled at the reference's
        # preemption-sync cadence.  FTC_PROFILE=0 stops the poll; the poll
        # does not depend on the tracing kill switch
        window = ProfileWindow(artifacts_dir, self.device)
        prof_first = start_step + cfg.profile_start_step
        want_profile = cfg.profile_steps > 0
        if want_profile and start_step >= cfg.total_steps:
            logger.warning("profiling requested but the run is already complete "
                           "(resumed at step %d of %d); no trace will be captured",
                           start_step, cfg.total_steps)
            want_profile = False
        elif want_profile and prof_first >= cfg.total_steps:
            logger.warning("profile_start_step %d is past the run (total_steps %d); "
                           "profiling from the first step instead",
                           cfg.profile_start_step, cfg.total_steps)
            prof_first = start_step
        prof_last = prof_first + cfg.profile_steps  # exclusive
        profile_poll_on = os.environ.get("FTC_PROFILE", "1").strip().lower() not in (
            "0", "false", "no", "off")
        profile_poll = max(1, min(cfg.log_every, cfg.checkpoint_every))
        profile_req_path = os.path.join(artifacts_dir, "profile_request.json")
        try:
            for step_idx in range(start_step, cfg.total_steps):
                if want_profile and not window.active and step_idx >= prof_first:
                    # >= not ==: an on-demand window may span the configured
                    # start; the configured one then begins at the first free step
                    window.start(step_idx)
                    want_profile = False
                    prof_last = min(step_idx + cfg.profile_steps, cfg.total_steps)
                if (profile_poll_on and not window.active and step_idx % profile_poll == 0
                        and os.path.exists(profile_req_path)):
                    steps_req = consume_profile_request(profile_req_path)
                    if steps_req:
                        window.start(step_idx)
                        prof_last = min(step_idx + steps_req, cfg.total_steps)
                iter_t0 = t_in = time.perf_counter()
                batch = next(it)
                dt_in = time.perf_counter() - t_in
                window_input_s += dt_in
                if obs_on:
                    phases.add("input", dt_in)
                window_steps += 1
                metrics = self.step(batch)
                window_tokens += tokens_per_batch
                if heartbeat is not None:
                    t_hb = time.perf_counter()
                    heartbeat.beat(step_idx + 1, step_ms=(t_hb - iter_t0) * 1000.0)
                    if obs_on:
                        phases.add("sync", time.perf_counter() - t_hb)
                if window.active and step_idx + 1 >= prof_last:
                    trace_path = window.stop(step_idx + 1)
                    # forced: an operator-requested window must confirm
                    # even with tracing off
                    events_log.emit("profile-captured", step=step_idx + 1, force=True)
                    logger.info("profiler trace for steps [%d, %d) -> %s",
                                window.first_step, step_idx + 1, trace_path)
                last = step_idx + 1 == cfg.total_steps
                eval_now = (cfg.eval_every > 0 and eval_it is not None
                            and ((step_idx + 1) % cfg.eval_every == 0 or last))
                log_now = (step_idx + 1) % cfg.log_every == 0 or last or eval_now
                if log_now:
                    # the step's launches return at once; reading its metrics
                    # back waits for the device, so the window's "compute"
                    # (its residual wall time) ends here, before eval runs
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - window_t0
                eval_metrics: dict[str, float] = {}
                eval_elapsed = 0.0
                if eval_now:
                    eval_t0 = time.perf_counter()
                    eval_metrics = self.evaluate(eval_it)
                    eval_elapsed = time.perf_counter() - eval_t0
                    if obs_on:
                        phases.add("eval", eval_elapsed)
                    logger.info("step %d eval_loss %.4f eval_acc %.3f", step_idx + 1,
                                eval_metrics["eval_loss"], eval_metrics["eval_accuracy"])
                if log_now:
                    metrics["tokens_per_sec"] = window_tokens / max(dt, 1e-9)
                    metrics["input_ms"] = window_input_s / max(window_steps, 1) * 1000.0
                    metrics["input_fraction"] = window_input_s / max(dt, 1e-9)
                    metrics.update(eval_metrics)
                    if obs_on:
                        metrics.update(phases.window_row(steps=window_steps,
                                                         wall_s=dt + eval_elapsed))
                    metrics.update(self._row_extras())
                    writer.write({"step": step_idx + 1, **metrics})
                    if on_metrics:
                        on_metrics(step_idx + 1, metrics)
                    logger.info("step %d loss %.4f acc %.3f tok/s %.0f input %.1fms"
                                " (%.1f%% of step)", step_idx + 1, metrics["loss"],
                                metrics["accuracy"], metrics["tokens_per_sec"],
                                metrics["input_ms"], 100.0 * metrics["input_fraction"])
                    window_t0, window_tokens, window_input_s, window_steps = (
                        time.perf_counter(), 0, 0.0, 0)
                if fault is not None:
                    # after the step (and its row): a SIGTERM's save reflects
                    # real progress; a SIGKILL may land inside an async save
                    # still in flight, whose staging the next attempt sweeps
                    fault.maybe_fire(step_idx + 1)
                preempt = guard.requested
                if (step_idx + 1) % cfg.checkpoint_every == 0 or last or preempt:
                    # the pending step's device work belongs to compute, not
                    # to the save that would otherwise wait for it
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    # mid-run saves overlap the next steps; the last save
                    # (nothing left to overlap) and a preemption save commit
                    # before going on
                    blocking = last or preempt or self._blocking_checkpoints
                    ck_span = spans.start("checkpoint", parent=fit_span, step=step_idx + 1,
                                          blocking=blocking)
                    t_ck = time.perf_counter()
                    host_state = self._checkpoint_state(ckpt)
                    # the snapshot, after any wait for the save in flight
                    snapshot_ms = (time.perf_counter() - t_ck) * 1000.0
                    ckpt.save(step_idx + 1, host_state, blocking=blocking,
                              manifest=self._build_manifest(step_idx + 1, host_state))
                    del host_state
                    if obs_on:
                        # the host-side cost of the save: snapshot + write for
                        # a blocking save, snapshot + handoff for an async one
                        phases.add("checkpoint", time.perf_counter() - t_ck)
                    spans.finish(ck_span, snapshot_ms=snapshot_ms)
                    events_log.emit("checkpoint-committed", step=step_idx + 1,
                                    blocking=blocking or None,
                                    kernel_launches=self._kernel_launches())
                if preempt:
                    logger.warning("exiting on preemption after step %d", step_idx + 1)
                    events_log.emit("preempt-exit", step=step_idx + 1)
                    raise SystemExit(143)
        finally:
            self._heartbeat = None
            for p in prefetch_its:
                p.close()
            if window.active:
                window.stop(cfg.total_steps)
            propagating = sys.exc_info()[1] is not None
            try:
                # durability barrier: an async save commits before fit
                # returns or the process exits
                ckpt.wait()
            except Exception:
                if not propagating:
                    raise
                # an exception (the preemption SystemExit 143) is already
                # propagating: log the save failure, keep the exit's meaning
                logger.exception("checkpoint save failed during teardown")
            finally:
                writer.close()
                guard.uninstall()
                spans.finish(fit_span, status="error" if propagating else "ok",
                             start_step=start_step)
                if not propagating:
                    events_log.emit("train-finished", step=cfg.total_steps,
                                    kernel_launches=self._kernel_launches())
