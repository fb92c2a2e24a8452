"""Synthetic LM datasets — the egress-free CI and benchmark workload (a copy
of the reference's ``data/synthetic.py``).

``task="increment"`` generates sequences where token[t+1] = (token[t] + 1)
mod vocab: a model that learns at all drives loss → 0 quickly, which gives
tests a crisp "training works" signal (the reference had no equivalent — its
smoke workload was a containerised MNIST it never ran in CI, SURVEY.md §4).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


#: distinct brightness levels in the multimodal task — spaced far enough
#: apart that the per-pixel noise averages out well below the level gap
BRIGHTNESS_LEVELS = 16


def synthetic_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    task: str = "increment",
    seed: int = 0,
    image_size: int = 0,
) -> Iterator[dict]:
    """Synthetic tasks:

    * ``increment`` — token[t+1] = token[t]+1 mod vocab; text-only.
    * ``random`` — iid tokens (loss should NOT beat log(vocab)).
    * ``brightness`` — multimodal wiring probe (requires ``image_size``):
      token 0 is a fixed BOS, token 1 encodes the image's mean brightness
      (one of :data:`BRIGHTNESS_LEVELS` levels), tokens 2+ increment from it.
      The brightness token is predictable ONLY through the vision path —
      ``loss_mask`` counts just that target, so the loss starts at
      log(vocab) and can only fall if pixels reach the decoder.
    """
    rng = np.random.default_rng(seed)
    if task == "brightness":
        if not image_size:
            raise ValueError("task='brightness' requires image_size > 0")
        if vocab_size < BRIGHTNESS_LEVELS:
            # vocab // levels == 0 would collapse every level onto the same
            # token — the probe would pass with no vision path at all
            raise ValueError(
                f"task='brightness' requires vocab_size >= {BRIGHTNESS_LEVELS}"
            )
    while True:
        if task == "increment":
            start = rng.integers(0, vocab_size, (batch_size, 1))
            offsets = np.arange(seq_len)[None, :]
            tokens = (start + offsets) % vocab_size
            loss_mask = np.ones((batch_size, seq_len), np.float32)
        elif task == "random":
            tokens = rng.integers(0, vocab_size, (batch_size, seq_len))
            loss_mask = np.ones((batch_size, seq_len), np.float32)
        elif task == "brightness":
            level = rng.integers(0, BRIGHTNESS_LEVELS, (batch_size, 1))
            start = level * (vocab_size // BRIGHTNESS_LEVELS)
            offsets = np.arange(seq_len)[None, :]
            tokens = (start + offsets) % vocab_size
            tokens[:, 0] = 0  # BOS carries no information about the level
            loss_mask = np.zeros((batch_size, seq_len), np.float32)
            loss_mask[:, 1] = 1.0  # only the brightness-determined target counts
        else:
            raise ValueError(f"unknown synthetic task {task!r}")
        batch = {
            "tokens": tokens.astype(np.int32),
            "loss_mask": loss_mask,
        }
        if image_size:
            if task == "brightness":
                brightness = level.astype(np.float32) / BRIGHTNESS_LEVELS
            else:
                brightness = tokens[:, :1].astype(np.float32) / vocab_size
            pixels = brightness[:, :, None, None] + 0.05 * rng.standard_normal(
                (batch_size, image_size, image_size, 3)
            )
            batch["pixels"] = pixels.astype(np.float32)
        yield batch
