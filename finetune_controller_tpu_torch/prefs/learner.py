"""RLHF-lite learner: the in-process actor/learner loop (counterpart of
``prefs/learner.py``).

The learner IS :class:`~.dpo_trainer.DPOTrainer`.  What makes it an
actor/learner loop is the BATCH STREAM: :func:`rollout_batch_stream` is an
iterator whose ``next()`` runs the actor's control loop before it yields a
batch —

1. reload the policy if the learner committed a new checkpoint
   (:meth:`~.actor.RolloutActor.maybe_reload`, so the actor picks up step
   N on the first batch after the commit);
2. enforce the staleness watermark on the rollout buffer (the learner never
   trains on pairs more than ``staleness_checkpoints`` checkpoints old);
3. top the buffer up with fresh on-policy pairs until it holds at least
   ``min_fill``;
4. yield a seed-deterministic DPO batch sampled from the buffer.

``Trainer.fit`` pulls batches synchronously (the in-process rlhf task
forces ``prefetch=0``), so actor and learner run round-robin on one card:
generate, then train, then generate.  With ``rollout_workers > 0`` the
actors run in worker processes instead and stream pairs to the learner
(``prefs/rollout_plane.py::build_remote_rlhf_loop``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Iterator

from .actor import RolloutActor, increment_prompts, increment_reward
from .dpo_trainer import DPOTrainer
from .rollout_buffer import RolloutBuffer

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RolloutConfig:
    """Knobs of the actor/learner loop (the job spec's ``rollout`` section;
    the ``FTC_RLHF_*`` variables override them per process)."""

    pairs_per_round: int = 16
    buffer_capacity: int = 256
    #: min pairs in the buffer before the learner takes a batch
    min_fill: int = 16
    #: drop pairs older than this many CHECKPOINTS behind the newest commit
    staleness_checkpoints: int = 2
    temperature: float = 0.8
    top_k: int = 0
    max_new_tokens: int = 16
    #: decode lanes of the actor's serving engine
    slots: int = 4
    #: consecutive pair-less rollout rounds tolerated before the learner
    #: proceeds on a partially-filled buffer (or fails on an empty one)
    max_empty_rounds: int = 25
    #: the learned reward model's endpoint (its ``reward_score`` RPC), read
    #: by remote rollout workers only
    reward_host: str = ""
    reward_port: int = 0

    _ENV_FIELDS = {
        "pairs_per_round": "FTC_RLHF_PAIRS_PER_ROUND",
        "buffer_capacity": "FTC_RLHF_BUFFER_CAPACITY",
        "min_fill": "FTC_RLHF_MIN_FILL",
        "staleness_checkpoints": "FTC_RLHF_STALENESS_CHECKPOINTS",
        "temperature": "FTC_RLHF_TEMPERATURE",
        "top_k": "FTC_RLHF_TOP_K",
        "max_new_tokens": "FTC_RLHF_MAX_NEW_TOKENS",
        "slots": "FTC_RLHF_SLOTS",
        "reward_host": "FTC_RLHF_REWARD_HOST",
        "reward_port": "FTC_RLHF_REWARD_PORT",
    }

    def apply_env_overrides(self) -> "RolloutConfig":
        """The operator's ``FTC_RLHF_*`` overrides (read in the job's
        process, not the controller)."""
        out = self
        for field, env in self._ENV_FIELDS.items():
            raw = os.environ.get(env)
            if raw is None:
                continue
            kind = type(getattr(self, field))
            out = dataclasses.replace(out, **{field: kind(raw)})
        return out


def rollout_batch_stream(actor: RolloutActor, buffer: RolloutBuffer, *, batch_size: int,
                         seq_len: int, checkpoint_every: int,
                         rollout: RolloutConfig) -> Iterator[dict]:
    """The learner's infinite batch source — see the module docstring."""
    while True:
        reloaded = actor.maybe_reload()
        min_version = actor.version - rollout.staleness_checkpoints * checkpoint_every
        buffer.evict_below(min_version, watermark=actor.version)
        if reloaded:
            # fresh policy ⇒ one generation round of fresh on-policy data,
            # even when nothing was evicted yet
            for pair in actor.generate_pairs(rollout.pairs_per_round):
                buffer.push(pair)
        empty_rounds = 0
        while buffer.depth < rollout.min_fill:
            fresh = actor.generate_pairs(rollout.pairs_per_round)
            for pair in fresh:
                buffer.push(pair)
            if fresh:
                empty_rounds = 0
                continue
            # an all-ties round: early (near-uniform samples the oracle
            # bootstrap usually breaks) or at convergence (every candidate
            # scores 1.0).  Past the cap, train on what the buffer holds; an
            # empty buffer is a wedged reward function
            empty_rounds += 1
            logger.info("rollout round %d produced no ranked pairs (%d empty in a row)",
                        actor.rounds, empty_rounds)
            if empty_rounds >= rollout.max_empty_rounds:
                if buffer.depth > 0:
                    logger.info("proceeding below min_fill (%d/%d pairs) after %d "
                                "pair-less rounds — policy likely converged",
                                buffer.depth, rollout.min_fill, empty_rounds)
                    break
                raise RuntimeError(
                    f"{empty_rounds} consecutive rollout rounds produced no "
                    "preference pairs and the buffer is empty — the reward "
                    "function cannot rank this policy's samples"
                )
        yield buffer.sample_batch(batch_size, seq_len)


def build_rlhf_loop(trainer: DPOTrainer, artifacts_dir: str, *,
                    rollout: RolloutConfig | None = None, prompt_fraction: float = 0.5
                    ) -> tuple[Iterator[dict], RolloutActor, RolloutBuffer]:
    """Wire an actor + buffer + batch stream onto a DPO learner.

    The actor decodes over the learner's own base tensors.  ``fit`` loads a
    ``pretrained_dir`` into them in place before it draws the first batch,
    so the actor's step-0 policy is the learner's and the base is loaded
    once (the reference initialises and loads it twice).  The adapter always
    comes from committed checkpoints.  One process: the shard offset of the
    reference's seeds is 0."""
    rollout = (rollout or RolloutConfig()).apply_env_overrides()
    cfg = trainer.cfg
    vocab = trainer.model_cfg.vocab_size
    prompt_len = max(2, int(cfg.seq_len * prompt_fraction))
    actor = RolloutActor(
        trainer.model,
        f"{artifacts_dir}/checkpoints",
        reward_fn=lambda p, c: increment_reward(p, c, vocab),
        prompts=increment_prompts(cfg.seq_len, vocab, cfg.seed + 7919, prompt_fraction),
        # the reward-optimal continuation — the cold-start bootstrap side
        oracle_fn=lambda p, n: [(p[-1] + 1 + i) % vocab for i in range(n)],
        prompt_bucket=prompt_len,
        max_new_tokens=min(rollout.max_new_tokens, cfg.seq_len - prompt_len),
        temperature=rollout.temperature,
        top_k=rollout.top_k,
        slots=rollout.slots,
        seed=cfg.seed,
    )
    buffer = RolloutBuffer(rollout.buffer_capacity, seed=cfg.seed,
                           # versions are checkpoint STEPS; staleness counts
                           # checkpoints, the unit of staleness_checkpoints
                           version_granularity=max(1, cfg.checkpoint_every))
    stream = rollout_batch_stream(actor, buffer, batch_size=cfg.batch_size,
                                  seq_len=cfg.seq_len, checkpoint_every=cfg.checkpoint_every,
                                  rollout=rollout)

    def stats() -> dict:
        return {**buffer.stats(), "actor_tokens_per_sec": round(actor.tokens_per_sec, 1),
                "actor_version": actor.version}

    trainer.rollout_stats_fn = stats
    return stream, actor, buffer
