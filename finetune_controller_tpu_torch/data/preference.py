"""Preference-pair datasets: (prompt, chosen, rejected) → padded DPO batches
(a copy of the reference's ``data/preference.py``: numpy only, so the port's
batches equal the reference's bit for bit).

The DPO batch contract (``prefs/dpo_trainer.py``) is four (B, S) leaves::

    {"chosen_tokens", "chosen_mask", "rejected_tokens", "rejected_mask"}

where chosen/rejected share the SAME prompt prefix and each mask is 1 only
over completion *targets* (prompt and padding are 0 — the convention
``train/losses.py`` uses, so masked-logprob parity holds).  Batches are plain
dicts of numpy arrays, so they ride the existing background-prefetch path
(``data/prefetch.py``) unchanged.

Two sources:

* :func:`synthetic_preference_batches` — the egress-free CI/benchmark
  workload: prompts are increment sequences (``data/synthetic.py``'s task),
  the chosen completion continues the increment and the rejected one breaks
  it.  Deterministic per seed; the eval stream draws from a disjoint seed
  region exactly like the SFT synthetic loader.
* :func:`preference_jsonl_batches` — real datasets: jsonl rows with
  ``{"prompt", "chosen", "rejected"}`` text (tokenized with the shared
  encoders) or pre-tokenized ``{"prompt_tokens", "chosen_tokens",
  "rejected_tokens"}`` lists.
"""

from __future__ import annotations

import json
import logging
from typing import Iterator

import numpy as np

from .loader import make_encoders

logger = logging.getLogger(__name__)


def _pad_pair(
    prompt: list[int], completion: list[int], seq_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, mask) both (seq_len,) — prompt+completion right-padded with 0;
    mask counts completion targets only.  Over-long rows keep the FULL prompt
    and truncate the completion (a truncated prompt would make chosen and
    rejected diverge before the completion even starts)."""
    if len(prompt) >= seq_len:
        prompt = prompt[: seq_len - 1]  # leave >= 1 completion slot
    completion = completion[: seq_len - len(prompt)]
    tokens = np.zeros((seq_len,), np.int32)
    mask = np.zeros((seq_len,), np.float32)
    n = len(prompt) + len(completion)
    tokens[: len(prompt)] = prompt
    tokens[len(prompt): n] = completion
    mask[len(prompt): n] = 1.0
    return tokens, mask


def _stack_pairs(
    pairs: list[tuple[list[int], list[int], list[int]]], seq_len: int
) -> dict:
    """[(prompt, chosen, rejected)] → the 4-leaf DPO batch dict."""
    ct, cm, rt, rm = [], [], [], []
    for prompt, chosen, rejected in pairs:
        t, m = _pad_pair(prompt, chosen, seq_len)
        ct.append(t); cm.append(m)
        t, m = _pad_pair(prompt, rejected, seq_len)
        rt.append(t); rm.append(m)
    return {
        "chosen_tokens": np.stack(ct),
        "chosen_mask": np.stack(cm),
        "rejected_tokens": np.stack(rt),
        "rejected_mask": np.stack(rm),
    }


# ---------------------------------------------------------------------------
# Synthetic pairs (the seeded CI / benchmark workload)
# ---------------------------------------------------------------------------


def make_increment_pair(
    rng: np.random.Generator,
    seq_len: int,
    vocab_size: int,
    prompt_fraction: float = 0.5,
) -> tuple[list[int], list[int], list[int]]:
    """One (prompt, chosen, rejected) increment pair.

    Prompt: ``start, start+1, ...`` — chosen continues the +1 stride, the
    rejected completion walks a corrupted stride (uniformly 2..7, never 1) so
    it is *systematically* wrong, not just noisy: a policy that learns the
    increment rule ranks held-out pairs correctly, which is what the
    ``dpo_accuracy`` eval gate measures.
    """
    prompt_len = max(2, int(seq_len * prompt_fraction))
    completion_len = seq_len - prompt_len
    start = int(rng.integers(0, vocab_size))
    prompt = [(start + i) % vocab_size for i in range(prompt_len)]
    nxt = prompt[-1]
    chosen = [(nxt + 1 + i) % vocab_size for i in range(completion_len)]
    stride = int(rng.integers(2, 8))
    rejected = [(nxt + stride * (i + 1)) % vocab_size
                for i in range(completion_len)]
    return prompt, chosen, rejected


def synthetic_preference_batches(
    batch_size: int,
    seq_len: int,
    vocab_size: int,
    seed: int = 0,
    prompt_fraction: float = 0.5,
) -> Iterator[dict]:
    """Infinite deterministic stream of increment preference batches.

    Same seed → bit-identical pair stream (tested round-trip); callers hold
    out an eval split by offsetting the seed, exactly like
    ``train/cli.py``'s synthetic SFT streams.
    """
    if vocab_size < 16:
        raise ValueError("preference task needs vocab_size >= 16")
    rng = np.random.default_rng(seed)
    while True:
        pairs = [
            make_increment_pair(rng, seq_len, vocab_size, prompt_fraction)
            for _ in range(batch_size)
        ]
        yield _stack_pairs(pairs, seq_len)


# ---------------------------------------------------------------------------
# JSONL pairs (real datasets)
# ---------------------------------------------------------------------------


def load_preference_rows(
    path: str, tokenizer_file: str | None = None
) -> list[tuple[list[int], list[int], list[int]]]:
    """Parse a preference jsonl into (prompt, chosen, rejected) token rows."""
    encode, _ = make_encoders(tokenizer_file)
    rows: list[tuple[list[int], list[int], list[int]]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if {"prompt_tokens", "chosen_tokens", "rejected_tokens"} <= set(row):
                rows.append((
                    [int(t) for t in row["prompt_tokens"]],
                    [int(t) for t in row["chosen_tokens"]],
                    [int(t) for t in row["rejected_tokens"]],
                ))
                continue
            if {"prompt", "chosen", "rejected"} <= set(row):
                rows.append((
                    encode(row["prompt"]),
                    encode(row["chosen"]),
                    encode(row["rejected"]),
                ))
                continue
            raise ValueError(
                "preference jsonl rows need 'prompt'/'chosen'/'rejected' "
                "(text) or 'prompt_tokens'/'chosen_tokens'/'rejected_tokens' "
                f"fields; got keys {sorted(row)}"
            )
    if not rows:
        raise ValueError(f"no preference pairs found in {path}")
    for i, (p, c, r) in enumerate(rows):
        if not p or not c or not r:
            raise ValueError(
                f"preference row {i}: prompt/chosen/rejected must all be "
                "non-empty"
            )
    return rows


def preference_jsonl_batches(
    path: str,
    batch_size: int,
    seq_len: int,
    tokenizer_file: str | None = None,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[dict]:
    """Infinite shuffled batch stream over a preference jsonl.

    Multi-host: each process takes a strided shard of the shuffled row order
    (the ``data/loader.py`` convention) so no two hosts train on the same
    pair in an epoch.
    """
    rows = load_preference_rows(path, tokenizer_file)
    rng = np.random.default_rng(seed)
    n = len(rows)
    warned = False
    while True:
        order = rng.permutation(n)[shard_index::shard_count]
        if not len(order):
            if not warned:
                logger.warning(
                    "preference dataset has %d pairs for %d shards; shard %d "
                    "falls back to the full set (hosts will overlap)",
                    n, shard_count, shard_index,
                )
                warned = True
            order = rng.permutation(n)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield _stack_pairs(
                [rows[j] for j in order[i: i + batch_size]], seq_len
            )
        if len(order) < batch_size:
            # shard smaller than one batch: tile its own rows
            idx = np.resize(order, batch_size)
            yield _stack_pairs([rows[j] for j in idx], seq_len)
