"""Multimodal data pipeline: image-bearing jsonl → (tokens, pixels) batches (a
copy of the reference's ``data/mm_loader.py``).

Row schema: the text loader's schemas (``data/loader.py`` — ``text``,
``prompt``/``completion``, token lists, chat ``messages``) plus an ``image``
field referencing the picture (path relative to the dataset file, absolute
path, data URI, or bare base64 — ``data/images.py``).

Layout differs from the text packer on purpose: one SAMPLE per row (no
cross-document packing — each image belongs to exactly one conversation),
text padded/truncated to a static ``seq_len``, pixels resized to the model's
``image_size``. The model prepends the projected patch tokens, so the static
shape per step is ``n_patches + seq_len`` — one compiled program for the
whole run. Reference dataset contract: ``app/models/base/finetuning.py:37-49``.
"""

from __future__ import annotations

import json
import logging
from collections import OrderedDict
from pathlib import Path
from typing import Iterator

import numpy as np

from .images import preprocess_image
from .loader import make_encoders, parse_text_row

logger = logging.getLogger(__name__)

#: decoded-pixel LRU cap: ~336²·3·4B ≈ 1.4 MB per image → ~700 MB ceiling
_PIXEL_CACHE_MAX = 512


class PixelCache:
    """Bounded LRU for decoded pixel arrays, keyed by row index.

    A real LRU, not clear-everything-at-capacity: steady-state epochs over a
    dataset just past the cap evict only the least-recently-used entries, so
    most rows keep their decode instead of the whole dataset re-decoding
    every epoch. ``capacity <= 0`` disables caching entirely (every access
    decodes — what the input-pipeline bench uses to measure raw decode cost).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._entries: OrderedDict[int, np.ndarray] = OrderedDict()

    def get(self, key: int) -> np.ndarray | None:
        px = self._entries.get(key)
        if px is not None:
            self._entries.move_to_end(key)
        return px

    def put(self, key: int, px: np.ndarray) -> None:
        if self.capacity <= 0:
            return
        if key in self._entries:
            self._entries.move_to_end(key)
        elif len(self._entries) >= self.capacity:
            self._entries.popitem(last=False)
        self._entries[key] = px

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: int) -> bool:
        return key in self._entries


def load_mm_rows(
    path: str, tokenizer_file: str | None = None
) -> list[tuple[list[int], list[int], str]]:
    """Parse rows to (tokens, loss_flags, image_ref). Every row must carry
    an ``image`` — a text-only row in a multimodal dataset is almost always
    a mistake (its loss would silently train the decoder on a black image)."""
    encode, encode_fragment = make_encoders(tokenizer_file)
    header_cache: dict[str, list[int]] = {}
    rows: list[tuple[list[int], list[int], str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            image = row.get("image")
            if not image:
                raise ValueError(
                    "multimodal jsonl rows must carry an 'image' field "
                    f"(path / data URI / base64). Row: {line[:120]}"
                )
            toks, flags = parse_text_row(
                row, encode, encode_fragment, header_cache, line=line
            )
            rows.append((toks, flags, str(image)))
    if not rows:
        raise ValueError(f"no rows found in {path}")
    return rows


def mm_jsonl_batches(
    path: str,
    batch_size: int,
    seq_len: int,
    image_size: int,
    tokenizer_file: str | None = None,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
    normalize: str = "clip",
    pixel_cache_size: int | None = None,
) -> Iterator[dict]:
    """Infinite shuffled sample batches:
    ``{"tokens": (B, S) i32, "loss_mask": (B, S) f32, "pixels": (B, H, W, 3)
    f32}``. Text longer than ``seq_len`` truncates (the image prefix rides
    inside the model, so S here is text-only); shorter pads with zeros whose
    loss_mask is 0. Multi-host: strided shard of the row stream."""
    rows = load_mm_rows(path, tokenizer_file)
    base_dir = Path(path).resolve().parent
    rng = np.random.default_rng(seed)
    pixel_cache = PixelCache(
        _PIXEL_CACHE_MAX if pixel_cache_size is None else pixel_cache_size
    )
    truncated = 0
    for i, (toks, flags, _) in enumerate(rows):
        if len(toks) > seq_len:
            truncated += 1
        if not any(flags):
            # no loss-counted tokens at ALL (empty completion, empty text):
            # the row would contribute ZERO gradient every epoch — the same
            # silent failure the chat-row empty-mask check in data/loader.py
            # catches, so refuse it here too
            raise ValueError(
                f"row {i}: no loss-counted tokens (empty completion?): the "
                "sample would train on nothing every epoch"
            )
        if not any(flags[:seq_len]):
            # truncation cut away every loss position (e.g. a prompt longer
            # than seq_len): the sample would contribute ZERO gradient every
            # epoch — fail loudly rather than silently training on nothing
            raise ValueError(
                f"row {i}: all loss-counted tokens fall past seq_len "
                f"{seq_len} (prompt length {flags.index(1)}); raise seq_len "
                "or shorten the prompt"
            )
    if truncated:
        logger.warning(
            "%d/%d multimodal rows exceed seq_len %d and will truncate",
            truncated, len(rows), seq_len,
        )

    def sample(idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        toks, flags, image = rows[idx]
        toks, flags = toks[:seq_len], flags[:seq_len]
        pad = seq_len - len(toks)
        t = np.asarray(toks + [0] * pad, np.int32)
        m = np.asarray(flags + [0] * pad, np.float32)
        px = pixel_cache.get(idx)
        if px is None:
            px = preprocess_image(
                image, image_size, base_dir=base_dir, normalize=normalize
            )
            pixel_cache.put(idx, px)
        return t, m, px

    n = len(rows)
    warned = False
    while True:
        order = rng.permutation(n)[shard_index::shard_count]
        if not len(order):
            if not warned:
                logger.warning(
                    "dataset has %d rows for %d shards; shard %d falls back "
                    "to the full row set (hosts will overlap)",
                    n, shard_count, shard_index,
                )
                warned = True
            order = rng.permutation(n)
        if len(order) < batch_size:
            order = np.resize(order, batch_size)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            parts = [sample(int(j)) for j in order[i:i + batch_size]]
            yield {
                "tokens": np.stack([p[0] for p in parts]),
                "loss_mask": np.stack([p[1] for p in parts]),
                "pixels": np.stack([p[2] for p in parts]),
            }
