"""DPO on top of the LoRA trainer (counterpart of ``prefs/dpo_trainer.py``).

:class:`DPOTrainer` swaps the objective and nothing else: the step with
gradient accumulation, checkpoints, resume, preemption handling, the
heartbeat and the metrics CSV are ``train/trainer.py``'s.  The metrics rows
gain ``reward_margin`` and ``dpo_accuracy`` (plus their ``eval_`` twins on
the eval cadence).

The reference model costs no memory: in LoRA mode the policy is base +
adapter, so the reference forward is the same model with its adapter
branches switched off (``LlamaForCausalLM.adapters_disabled``) under
``torch.no_grad()``: the frozen base's output on the same weights, no second
copy, no gradient path into the adapters, and no dropout (LoRA dropout lives
in the adapter branch).  It is the profiler range ``dpo_reference_forward``.

Batch contract (``data/preference.py``)::

    {"chosen_tokens", "chosen_mask", "rejected_tokens", "rejected_mask"}

Chosen and rejected rows are stacked into ONE ``(2B, S)`` forward per model
(policy and reference), so a DPO step costs two forwards of twice the batch
(the policy's with a backward), not four.  With ``grad_accum_steps > 1`` the
trainer splits every leaf alike, so microbatch ``i`` holds pairs
``[i*b:(i+1)*b]`` of both sides and stacks them to ``2b`` rows.
"""

from __future__ import annotations

import logging

import torch

from ..train.trainer import Trainer
from .losses import dpo_loss, masked_sequence_logprobs

logger = logging.getLogger(__name__)


def stack_pairs(batch: dict) -> tuple[int, torch.Tensor, torch.Tensor]:
    """``(B, tokens (2B, S), masks (2B, S))``: chosen rows then rejected."""
    b = batch["chosen_tokens"].shape[0]
    tokens = torch.cat([batch["chosen_tokens"], batch["rejected_tokens"]]).long()
    masks = torch.cat([batch["chosen_mask"], batch["rejected_mask"]])
    return b, tokens, masks


class DPOTrainer(Trainer):
    """Preference-pair trainer (``TrainConfig.task == "dpo"``/``"rlhf"``).

    Restrictions, checked at construction with the reference's words: LoRA
    mode only (the adapter-disabled reference is what makes the reference
    model free), dense text models (MoE capacity routing couples the stacked
    chosen/rejected rows; the multimodal prefix has no pair semantics), and
    ``dpo_beta > 0``."""

    def __init__(self, model_cfg, train_cfg, device=None):
        if train_cfg.mode != "lora":
            raise ValueError(
                "DPO requires mode='lora': the reference model is the "
                "adapter-disabled base, which only exists in LoRA mode"
            )
        if getattr(model_cfg, "n_experts", 0):
            raise ValueError("DPO does not support MoE configs")
        if getattr(model_cfg, "vision", None) is not None:
            raise ValueError("DPO supports text models only")
        if train_cfg.dpo_beta <= 0:
            raise ValueError(f"dpo_beta must be > 0, got {train_cfg.dpo_beta}")
        super().__init__(model_cfg, train_cfg, device=device)
        #: host-side metrics of the rlhf learner (rollout buffer depth and
        #: staleness, actor tokens/s), merged into every logged row
        self.rollout_stats_fn = None
        if train_cfg.task == "rlhf" and not train_cfg.rollout_workers:
            # the IN-PROCESS loop only.  Its actor sees only COMMITTED
            # checkpoints; synchronous commits bound its policy lag to one
            # round, where an async save could land arbitrarily many rounds
            # late
            self._blocking_checkpoints = True
            if train_cfg.prefetch:
                # the rollout stream runs the actor inside next(): a prefetch
                # thread would decode on the card beside the learner's step
                logger.info("rlhf task: forcing prefetch=0 (actor runs inline)")
                train_cfg.prefetch = 0
        # remote rollout workers (rollout_workers > 0) keep both: the actors
        # decode in their own processes, and the plane pushes a policy only
        # after latest_step() reports its commit durable
        # (prefs/rollout_plane.py)

    # ---- objective -------------------------------------------------------

    def _pair_logprobs(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(chosen_lp, rejected_lp), each (B,): one stacked (2B, S) forward
        of the model as it stands (adapters on or off, grad or no grad)."""
        b, tokens, masks = stack_pairs(batch)
        logits = self.model(tokens)
        lp = masked_sequence_logprobs(logits, tokens, masks)
        return lp[:b], lp[b:]

    def reference_logprobs(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """The frozen reference's (chosen_lp, rejected_lp): the adapterless
        base under ``no_grad``."""
        with torch.no_grad(), self.model.adapters_disabled(), \
                torch.profiler.record_function("dpo_reference_forward"):
            return self._pair_logprobs(batch)

    def _loss(self, batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        pc, pr = self._pair_logprobs(batch)
        rc, rr = self.reference_logprobs(batch)
        loss, metrics = dpo_loss(pc, pr, rc, rr, self.cfg.dpo_beta)
        # fit()'s log line and the eval_* naming expect loss/accuracy keys;
        # accuracy IS the pair-ranking accuracy for a preference objective
        metrics["accuracy"] = metrics["dpo_accuracy"]
        metrics["policy_chosen_logprob"] = pc.detach().mean()
        metrics["policy_rejected_logprob"] = pr.detach().mean()
        return loss, metrics

    def _eval_metrics(self, batch: dict) -> dict[str, torch.Tensor]:
        return self._loss(batch)[1]

    # ---- metrics plumbing ------------------------------------------------

    def _writer_extra_fields(self, eval_enabled: bool) -> tuple[str, ...]:
        fields = super()._writer_extra_fields(eval_enabled)
        if eval_enabled:
            fields += ("eval_reward_margin", "eval_dpo_accuracy")
        if self.rollout_stats_fn is not None:
            fields += ("rollout_buffer_depth", "rollout_staleness",
                       "actor_tokens_per_sec", "actor_version")
            if self.cfg.rollout_workers:
                fields += ("rollout_workers_alive", "rollout_respawns_total",
                           "rollout_dup_pairs_total")
        return fields

    def _row_extras(self) -> dict:
        if self.rollout_stats_fn is None:
            return {}
        return {k: float(v) for k, v in self.rollout_stats_fn().items()}
