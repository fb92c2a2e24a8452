"""Learned reward model: a scalar head trained on the DPO data path
(counterpart of ``prefs/reward_trainer.py``).

``TrainConfig.task == "reward"`` rides the whole trainer — step with
gradient accumulation, checkpoints, resume, eval cadence, metrics CSV — and
swaps only the trained leaves and the objective:

* **trained** = the trunk's LoRA adapters plus a head over the logits,
  ``head.a`` (shape ``()``, init 1), ``head.w`` (``(V,)``, init 0) and
  ``head.b`` (``()``, init 0), all f32 (the reference's ``{"lora", "head":
  {"a", "w", "b"}}`` tree; the checkpoint's ``trainable`` carries the head
  under ``head.*``).  At init the score is the mean completion logprob, so
  Bradley–Terry training starts from a ranking signal;
* **loss** = :func:`~.losses.reward_scores` then
  :func:`~.losses.bradley_terry_loss` over the stacked ``(2B, S)`` forward.

:meth:`RewardModelTrainer.export_artifacts` writes the PEFT adapter as every
LoRA job does plus ``reward_head.msgpack`` at the artifact root, byte for
byte as ``flax.serialization.msgpack_serialize`` writes the reference's
(``utils/flax_msgpack.py``); :func:`read_reward_head` reads it back.
"""

from __future__ import annotations

import os

import torch

from ..train.trainer import Trainer
from ..utils import flax_msgpack
from .dpo_trainer import stack_pairs
from .losses import bradley_terry_loss, reward_scores

REWARD_HEAD_FILENAME = "reward_head.msgpack"
#: the head's leaves in the checkpoint's ``trainable``
HEAD_PREFIX = "head."


def read_reward_head(artifacts_dir: str) -> dict[str, torch.Tensor]:
    """``{"a", "w", "b"}`` f32 tensors of a reward job's exported head."""
    with open(os.path.join(artifacts_dir, REWARD_HEAD_FILENAME), "rb") as f:
        tree = flax_msgpack.restore(f.read())
    return {k: torch.as_tensor(v.copy()) for k, v in tree.items()}


class RewardModelTrainer(Trainer):
    """Bradley–Terry reward model (``TrainConfig.task == "reward"``).  The
    construction refusals are the reference's: LoRA mode only, dense text
    models."""

    def __init__(self, model_cfg, train_cfg, device=None):
        if train_cfg.mode != "lora":
            raise ValueError(
                "task='reward' requires mode='lora': the reward model is "
                "the policy trunk's adapter plus a scalar head"
            )
        if getattr(model_cfg, "n_experts", 0):
            raise ValueError("reward training does not support MoE configs")
        if getattr(model_cfg, "vision", None) is not None:
            raise ValueError("reward training supports text models only")
        super().__init__(model_cfg, train_cfg, device=device)

    def _extra_trainable(self) -> dict[str, torch.nn.Parameter]:
        kw = dict(dtype=torch.float32, device=self.device)
        return {
            "head.a": torch.nn.Parameter(torch.ones((), **kw)),
            "head.w": torch.nn.Parameter(torch.zeros(self.model_cfg.vocab_size, **kw)),
            "head.b": torch.nn.Parameter(torch.zeros((), **kw)),
        }

    @property
    def head(self) -> dict[str, torch.Tensor]:
        return {k[len(HEAD_PREFIX):]: v for k, v in self.trainable.items()
                if k.startswith(HEAD_PREFIX)}

    # ---- objective --------------------------------------------------------

    def scores(self, batch: dict) -> torch.Tensor:
        """(2B,) scores of the stacked chosen then rejected rows."""
        _, tokens, masks = stack_pairs(batch)
        return reward_scores(self.model(tokens), tokens, masks, self.head)

    def _loss(self, batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        b = batch["chosen_tokens"].shape[0]
        scores = self.scores(batch)
        loss, metrics = bradley_terry_loss(scores[:b], scores[b:])
        # accuracy IS pairwise ranking accuracy for a reward model (the
        # held-out number the promotion gate reads)
        metrics["accuracy"] = metrics["bt_accuracy"]
        return loss, metrics

    def _eval_metrics(self, batch: dict) -> dict[str, torch.Tensor]:
        return self._loss(batch)[1]

    def _writer_extra_fields(self, eval_enabled: bool) -> tuple[str, ...]:
        fields = super()._writer_extra_fields(eval_enabled)
        if eval_enabled:
            fields += ("eval_reward_margin", "eval_bt_accuracy")
        return fields

    # ---- export -----------------------------------------------------------

    def export_artifacts(self, artifacts_dir: str) -> None:
        """The trunk's adapter (PEFT layout, as every LoRA job) and the
        head as ``reward_head.msgpack`` at the artifact root."""
        head = {k: v.detach().to("cpu").numpy() for k, v in self.head.items()}
        path = os.path.join(artifacts_dir, REWARD_HEAD_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(flax_msgpack.serialize(head))
        os.replace(tmp, path)
        super().export_artifacts(artifacts_dir)
