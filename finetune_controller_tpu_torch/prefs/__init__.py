"""Preference optimization (counterpart of ``prefs/``): DPO as a job type,
the Bradley–Terry reward model, the in-process RLHF-lite actor/learner loop
and the disaggregated rollout plane (``rollout_plane.py``: remote rollout
workers, ``reward_score`` workers and the remote learner)."""

from .dpo_trainer import DPOTrainer
from .losses import dpo_loss, masked_sequence_logprobs
from .rollout_buffer import PreferencePair, RolloutBuffer

__all__ = [
    "DPOTrainer",
    "PreferencePair",
    "RolloutBuffer",
    "dpo_loss",
    "masked_sequence_logprobs",
]
