"""Bounded, seed-deterministic preference rollout buffer (a copy of the
reference's ``prefs/rollout_buffer.py``: numpy sampling, so a batch equals
the reference's bit for bit).

The queue between the actor (generates on-policy pairs from the latest
committed checkpoint) and the learner (consumes them through the DPO loss).
Three properties the actor/learner loop depends on:

* **bounded** — ``capacity`` caps memory; pushing past it drops the OLDEST
  pairs (on-policy data ages fastest, so FIFO eviction is also the freshest-
  data policy);
* **seed-deterministic** — sampling uses the buffer's own
  ``np.random.default_rng(seed)``, so a resumed/replayed run draws the same
  batches from the same contents;
* **staleness-capped** — every pair carries the checkpoint step (``version``)
  the actor generated it from; :meth:`evict_below` enforces the watermark so
  the learner never trains on pairs more than K checkpoints old.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from ..data.preference import _stack_pairs


@dataclasses.dataclass(frozen=True)
class PreferencePair:
    """One scored rollout pair, tagged with its generation provenance."""

    prompt: tuple[int, ...]
    chosen: tuple[int, ...]
    rejected: tuple[int, ...]
    #: checkpoint step of the policy the actor decoded with (0 = the base
    #: model before any commit)
    version: int
    reward_chosen: float = 0.0
    reward_rejected: float = 0.0


class RolloutBuffer:
    def __init__(self, capacity: int, seed: int = 0,
                 version_granularity: int = 1):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        #: versions per "checkpoint" for the :attr:`staleness` metric: pair
        #: versions are optimizer STEPS, but the staleness knob (and the
        #: exported gauge) count CHECKPOINTS — the learner passes
        #: ``checkpoint_every`` here so the two share a unit
        self.version_granularity = max(1, version_granularity)
        self._pairs: collections.deque[PreferencePair] = collections.deque(
            maxlen=capacity
        )
        self._rng = np.random.default_rng(seed)
        # counters (the learner's rollout_* metrics columns read these)
        self.pushed_total = 0
        self.evicted_stale_total = 0
        #: newest checkpoint step :meth:`evict_below` was told about
        self.watermark = 0

    def __len__(self) -> int:
        return len(self._pairs)

    @property
    def depth(self) -> int:
        return len(self._pairs)

    def push(self, pair: PreferencePair) -> None:
        self._pairs.append(pair)  # deque(maxlen) drops the oldest past cap
        self.pushed_total += 1

    def evict_below(self, min_version: int, *, watermark: int | None = None) -> int:
        """Drop pairs generated from a checkpoint older than ``min_version``
        (the staleness cap).  Returns how many were dropped."""
        if watermark is not None:
            self.watermark = max(self.watermark, watermark)
        kept = [p for p in self._pairs if p.version >= min_version]
        dropped = len(self._pairs) - len(kept)
        if dropped:
            self._pairs = collections.deque(kept, maxlen=self.capacity)
            self.evicted_stale_total += dropped
        return dropped

    @property
    def staleness(self) -> int:
        """CHECKPOINT lag of the OLDEST pair behind the watermark (0 =
        everything is from the newest known checkpoint) — raw step deltas
        divide by ``version_granularity``, rounded up."""
        if not self._pairs:
            return 0
        oldest = min(p.version for p in self._pairs)
        steps = max(0, self.watermark - oldest)
        return -(-steps // self.version_granularity)

    def sample_batch(self, batch_size: int, seq_len: int) -> dict:
        """A DPO batch (``data/preference.py`` layout) sampled from the
        buffer — without replacement when it is deep enough, tiled otherwise.
        Deterministic given the buffer's seed and call history."""
        if not self._pairs:
            raise ValueError("rollout buffer is empty")
        pairs = list(self._pairs)
        replace = len(pairs) < batch_size
        idx = self._rng.choice(len(pairs), size=batch_size, replace=replace)
        picked = [
            (list(pairs[i].prompt), list(pairs[i].chosen),
             list(pairs[i].rejected))
            for i in idx
        ]
        return _stack_pairs(picked, seq_len)

    def stats(self) -> dict:
        return {
            "rollout_buffer_depth": self.depth,
            "rollout_staleness": self.staleness,
            "rollout_pairs_total": self.pushed_total,
            "rollout_evicted_stale_total": self.evicted_stale_total,
        }
