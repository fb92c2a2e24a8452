"""Rollout actor: the serving engine driven by the learner's checkpoints
(counterpart of ``prefs/actor.py``).

The actor only ever sees the learner's COMMITTED checkpoints — weights flow
through the checkpoint channel, never through shared trainable state.  Per
round it:

1. :meth:`RolloutActor.maybe_reload` — if ``checkpoints/`` has a newer
   committed step, restore its adapter (``train/checkpoint.py``), fold it
   into the base kernels (``serve.loader.merge_lora_variables``) and swap
   the merged tensors into the engine's model in place of the previous
   policy's;
2. :meth:`RolloutActor.generate_pairs` — decode TWO sampled candidates per
   prompt through :class:`~..serve.engine.BatchEngine` (paged, so the paged
   attention kernel on the card), score them with the reward function and
   emit the better/worse completions as a
   :class:`~.rollout_buffer.PreferencePair` tagged with the checkpoint step.
   With ``batch_reward_fn`` (a served reward model's ``reward_score`` RPC)
   one call scores the round's ``2n`` candidates.

Weights: the engine's model is built over the learner's own base tensors
(no copy; the adapterless start IS the step-0 policy, LoRA's B matrices
being zero).  A merge writes NEW kernels — one serving-dtype copy of the
projection kernels, the old policy's freed before the next is built — and
never into the learner's frozen base, which the learner keeps training on.
Sampling cannot match JAX's random bits; seeds follow the reference's
formula per (actor seed, round, prompt, candidate), and at temperature 0
the pairs equal the reference's.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..models.convert import merged_config
from ..models.lora import LoRAConfig
from ..serve.engine import BatchEngine, EngineConfig, GenRequest
from ..serve.loader import _assemble, merge_lora_variables
from ..train.checkpoint import CheckpointManager
from .rollout_buffer import PreferencePair

logger = logging.getLogger(__name__)

_LORA_LEAVES = (".lora_a", ".lora_b")


def increment_reward(prompt: list[int], completion: list[int], vocab_size: int) -> float:
    """Reward for the synthetic increment task: the fraction of completion
    tokens that continue the +1 (mod vocab) sequence — the programmatic
    stand-in for a reward model (RLHF-*lite*)."""
    if not completion:
        return 0.0
    prev = prompt[-1]
    good = 0
    for tok in completion:
        if tok == (prev + 1) % vocab_size:
            good += 1
        prev = tok
    return good / len(completion)


def increment_prompts(seq_len: int, vocab_size: int, seed: int,
                      prompt_fraction: float = 0.5) -> Iterator[list[int]]:
    """Deterministic stream of increment prompts (the prompt half of
    ``data/preference.make_increment_pair``)."""
    rng = np.random.default_rng(seed)
    prompt_len = max(2, int(seq_len * prompt_fraction))
    while True:
        start = int(rng.integers(0, vocab_size))
        yield [(start + i) % vocab_size for i in range(prompt_len)]


class RolloutActor:
    """Generates scored preference pairs from the latest committed checkpoint.

    ``model`` is the learner's policy model (LoRA config); its non-adapter
    tensors are the base the engine decodes with.  ``ckpt_dir`` None is push
    mode: the policy arrives through :meth:`install_policy`; ``lora`` then
    names the adapter config of the pushed policies when ``model`` is the
    base alone (a remote rollout worker's)."""

    def __init__(
        self,
        model,
        ckpt_dir: str | None,
        *,
        reward_fn: Callable[[list[int], list[int]], float],
        prompts: Iterator[list[int]],
        batch_reward_fn: Callable[[list[tuple[list[int], list[int]]]], list[float]] | None = None,
        lora: LoRAConfig | None = None,
        oracle_fn: Callable[[list[int], int], list[int]] | None = None,
        prompt_bucket: int = 0,
        max_new_tokens: int = 16,
        temperature: float = 0.8,
        top_k: int = 0,
        slots: int = 4,
        seed: int = 0,
    ):
        self._model_cfg = model.cfg if lora is None else model.cfg.replace(lora=lora)
        #: the learner's base tensors, shared (never written here)
        self._base = {k: v for k, v in model.state_dict().items()
                      if not k.endswith(_LORA_LEAVES)}
        self._ckpt = (CheckpointManager(ckpt_dir, keep=10**9, sweep=False)
                      if ckpt_dir else None)
        self._reward_fn = reward_fn
        #: one call per round scores all 2n candidates (the remote reward
        #: model's batched RPC); ``reward_fn`` per candidate otherwise
        self._batch_reward_fn = batch_reward_fn
        self._prompts = prompts
        #: cold-start escape hatch: when a WHOLE round ties, ``oracle_fn(prompt,
        #: n)`` (the reward-optimal continuation) stands in as the chosen
        #: side against the sampled rollout.  None disables it
        self._oracle_fn = oracle_fn
        self.bootstrap_pairs = 0
        self._max_new_tokens = max_new_tokens
        self._temperature = temperature
        self._top_k = top_k
        self._seed = seed
        #: checkpoint step the engine currently decodes with (0 = base)
        self.version = 0
        self.reloads = 0
        self.rounds = 0
        self.pairs_generated = 0
        self.tokens_generated = 0
        self.generate_seconds = 0.0
        # one prefill bucket sized to the prompt distribution
        bucket = 8
        prompt_cap = prompt_bucket or max(2, int(self._model_cfg.max_seq_len))
        while bucket < prompt_cap:
            bucket <<= 1
        device = next(iter(self._base.values())).device
        self._engine = BatchEngine(
            _assemble(merged_config(self._model_cfg), dict(self._base), device),
            EngineConfig(
                slots=slots, prompt_buckets=(bucket,), max_new_tokens=max_new_tokens,
                # stale KV from a pre-reload policy must never splice into a
                # post-reload admission, so the prefix cache stays off
                prefix_cache_bytes=0,
            ),
        )

    @property
    def engine(self) -> BatchEngine:
        return self._engine

    # ---- weights ---------------------------------------------------------

    def _install(self, lora: dict[str, torch.Tensor]) -> None:
        """Serve base + ``lora`` merged (the base alone for an empty tree)."""
        model = self._engine.model
        # back to the shared base first, so the previous policy's merged
        # kernels are freed before the next ones are built
        model.load_state_dict(self._base, strict=True, assign=True)
        if lora:
            device = next(iter(self._base.values())).device
            state = dict(self._base)
            state.update({k: v.to(device) for k, v in lora.items()})
            _, merged = merge_lora_variables(self._model_cfg, state)
            model.load_state_dict(merged, strict=True, assign=True)

    def maybe_reload(self) -> bool:
        """Swap in the newest committed checkpoint's policy; True on reload."""
        if self._ckpt is None:
            return False  # push mode: install_policy is the only reload path
        latest = self._ckpt.latest_step()
        if latest is None or latest == self.version:
            return False
        trainable = self._ckpt.restore(latest)["trainable"]
        self._install({k: v for k, v in trainable.items() if k.endswith(_LORA_LEAVES)})
        self.version = latest
        self.reloads += 1
        logger.info("actor reloaded policy from checkpoint step %d", latest)
        return True

    def install_policy(self, version: int, lora_tree: dict | None) -> bool:
        """Push-mode rollover: install a learner-shipped adapter (the flat
        ``...lora_a``/``lora_b`` tensors of a checkpoint's ``trainable``).
        Idempotent and monotonic: a version at or below the installed one is
        a no-op."""
        version = int(version)
        if version <= self.version:
            return False
        self._install(dict(lora_tree or {}))
        self.version = version
        self.reloads += 1
        logger.info("actor installed pushed policy version %d", version)
        return True

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_generated / max(self.generate_seconds, 1e-9)

    # ---- rollouts --------------------------------------------------------

    def generate_pairs(self, n_pairs: int) -> list[PreferencePair]:
        """Decode 2 sampled candidates for each of ``n_pairs`` prompts and
        rank them by reward.  Ties are kept out of the buffer (a tied pair
        carries no preference signal)."""
        self.rounds += 1
        prompts = [next(self._prompts) for _ in range(n_pairs)]
        requests = [
            GenRequest(
                request_id=f"r{self.rounds}p{i}c{cand}", tokens=list(prompt),
                max_new_tokens=self._max_new_tokens, temperature=self._temperature,
                top_k=self._top_k,
                # deterministic per (actor seed, round, prompt, candidate)
                seed=(((self._seed * 1_000_003 + self.rounds) * 4093 + i) * 2 + cand),
            )
            for i, prompt in enumerate(prompts) for cand in range(2)
        ]
        t0 = time.perf_counter()
        results = self._engine.run(requests)
        self.generate_seconds += time.perf_counter() - t0
        all_outs = []
        for i in range(len(prompts)):
            outs = [results[f"r{self.rounds}p{i}c{c}"].generated for c in (0, 1)]
            self.tokens_generated += sum(len(o) for o in outs)
            all_outs.append(outs)
        if self._batch_reward_fn is not None:
            flat = self._batch_reward_fn([(p, o) for p, outs in zip(prompts, all_outs)
                                          for o in outs])
            all_rewards = [[float(flat[2 * i]), float(flat[2 * i + 1])]
                           for i in range(len(prompts))]
        else:
            all_rewards = [[self._reward_fn(p, o) for o in outs]
                           for p, outs in zip(prompts, all_outs)]
        pairs: list[PreferencePair] = []
        for prompt, outs, rewards in zip(prompts, all_outs, all_rewards):
            if rewards[0] == rewards[1]:
                continue
            hi, lo = (0, 1) if rewards[0] > rewards[1] else (1, 0)
            pairs.append(PreferencePair(
                prompt=tuple(prompt), chosen=tuple(outs[hi]), rejected=tuple(outs[lo]),
                version=self.version, reward_chosen=rewards[hi], reward_rejected=rewards[lo],
            ))
        if not pairs and self._oracle_fn is not None:
            # the whole round tied (cold-start noise): the reward-optimal
            # continuation beats any imperfect rollout
            for prompt, outs, rewards in zip(prompts, all_outs, all_rewards):
                if rewards[0] >= 1.0:
                    continue  # the rollout is already optimal; no signal
                oracle = self._oracle_fn(prompt, len(outs[0]) or 1)
                pairs.append(PreferencePair(
                    prompt=tuple(prompt), chosen=tuple(oracle), rejected=tuple(outs[0]),
                    version=self.version, reward_chosen=self._reward_fn(prompt, oracle),
                    reward_rejected=rewards[0],
                ))
                self.bootstrap_pairs += 1
        self.pairs_generated += len(pairs)
        return pairs
