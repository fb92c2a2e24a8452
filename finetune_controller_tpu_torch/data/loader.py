"""Host-side data pipeline: tokenized-JSONL → packed fixed-length batches.

A copy of the reference's ``data/loader.py``.  ``.jsonl`` datasets without a
tokenizer file go through the native C++ packer first
(``data/native_loader.py``), which gives the same blocks as the Python path.

Datasets are files in the object store (the control plane downloads them to a
local path before launch, mirroring the reference's init-container `s3 cp`
seam — reference ``app/jobs/kubeflow/PyTorchJobDeployer.py:70-91``).

Supported formats:
  * ``.jsonl`` with ``{"tokens": [...]}`` rows (pre-tokenized), or
    ``{"text": "..."}`` rows tokenized with a byte-level fallback tokenizer
    (or a HuggingFace ``tokenizers`` file when provided);
  * ``.jsonl`` SFT rows — ``{"prompt": ..., "completion": ...}`` (text) or
    ``{"prompt_tokens": [...], "completion_tokens": [...]}`` — where the loss
    counts ONLY completion tokens (the mask rides through packing);
  * ``.jsonl`` chat rows — ``{"messages": [{"role", "content"}, ...]}``
    rendered with a fixed template; loss counts assistant content only
    (see :func:`_render_chat`);
  * ``.npy`` — a flat int32 token stream.

Packing: documents are concatenated into a flat stream with per-document
``segment_ids`` so attention never crosses document boundaries, then cut into
(batch, seq_len) blocks — the TPU-friendly static-shape layout.

Multi-host: each process takes a strided shard of the block stream
(``shard_index``/``shard_count``), so no two hosts train on the same block.
"""

from __future__ import annotations

import json
import logging
from typing import Iterator, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _byte_tokenize(text: str) -> list[int]:
    return list(text.encode("utf-8"))


def _render_chat(messages, encode_fragment, header_cache: dict) -> "Document":
    """Render a chat row (``{"messages": [{"role", "content"}, ...]}``) with
    a fixed, deterministic template::

        <|role|>\\ncontent\\n

    Loss counts ONLY assistant-message content (+ its terminating newline);
    role headers and user/system turns are masked — every assistant turn in
    a multi-turn conversation contributes. Custom chat templates belong in
    preprocessing: render them to ``prompt``/``completion`` (or token) rows.

    ``encode_fragment`` must NOT add special tokens — fragments are
    concatenated, and a post-processor's per-call BOS/EOS would litter the
    stream mid-sequence. ``header_cache`` memoizes the handful of role
    headers across the whole file.
    """
    if not isinstance(messages, list) or not all(
        isinstance(m, dict) for m in messages
    ):
        raise ValueError(
            "'messages' must be a list of {'role', 'content'} objects"
        )
    toks: list[int] = []
    flags: list[int] = []
    for msg in messages:
        role = str(msg.get("role", "user"))
        header = header_cache.get(role)
        if header is None:
            header = header_cache[role] = encode_fragment(f"<|{role}|>\n")
        body = encode_fragment(str(msg.get("content", "")) + "\n")
        toks += header + body
        flags += [0] * len(header)
        flags += [1] * len(body) if role == "assistant" else [0] * len(body)
    return toks, flags


#: a document is (tokens, loss_flags) — flags mark the positions whose
#: prediction counts (1 everywhere for plain LM rows, completion-only for SFT)
Document = tuple[list[int], list[int]]


def make_encoders(tokenizer_file: str | None):
    """(encode, encode_fragment) pair: HF ``tokenizers`` file when given,
    byte-level fallback otherwise — shared by the text and multimodal
    loaders so tokenizer-handling fixes land in both."""
    tokenizer = None
    if tokenizer_file:
        from tokenizers import Tokenizer

        tokenizer = Tokenizer.from_file(tokenizer_file)

    def encode(text: str) -> list[int]:
        if tokenizer is not None:
            return tokenizer.encode(text).ids
        return _byte_tokenize(text)

    def encode_fragment(text: str) -> list[int]:
        # fragments get concatenated — a post-processor's BOS/EOS per call
        # would land mid-sequence
        if tokenizer is not None:
            return tokenizer.encode(text, add_special_tokens=False).ids
        return _byte_tokenize(text)

    return encode, encode_fragment


def load_token_documents(path: str, tokenizer_file: str | None = None) -> list[Document]:
    if path.endswith(".npy"):
        toks = np.load(path).astype(np.int32).tolist()
        return [(toks, [1] * len(toks))]
    encode, encode_fragment = make_encoders(tokenizer_file)
    header_cache: dict[str, list[int]] = {}
    docs: list[Document] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            docs.append(parse_text_row(
                json.loads(line), encode, encode_fragment, header_cache,
                line=line,
            ))
    if not docs:
        raise ValueError(f"no documents found in {path}")
    return docs


def parse_text_row(
    row: dict, encode, encode_fragment, header_cache: dict, line: str = ""
) -> Document:
    """One jsonl row → (tokens, loss_flags). Shared by the text loader and
    the multimodal loader (``data/mm_loader.py``), which reads the same text
    schemas next to an ``image`` field."""
    if "tokens" in row:
        toks = [int(t) for t in row["tokens"]]
        return toks, [1] * len(toks)
    if "text" in row:
        toks = encode(row["text"])
        return toks, [1] * len(toks)
    if "prompt_tokens" in row and "completion_tokens" in row:
        p = [int(t) for t in row["prompt_tokens"]]
        c = [int(t) for t in row["completion_tokens"]]
        return p + c, [0] * len(p) + [1] * len(c)
    if "prompt" in row and "completion" in row:
        p, c = encode(row["prompt"]), encode(row["completion"])
        return p + c, [0] * len(p) + [1] * len(c)
    if "messages" in row:
        doc = _render_chat(row["messages"], encode_fragment, header_cache)
        if not any(doc[1]):
            # an all-masked chat doc trains on NOTHING — the classic
            # wrong-role footgun ({"role": "model"}), caught per row
            # so a mixed corpus can't hide it
            raise ValueError(
                "chat row produced no assistant-content tokens (the "
                "loss mask is empty): the template counts loss only "
                f"for role == 'assistant'. Row: {line[:120]}"
            )
        return doc
    raise ValueError(
        "jsonl rows must have 'tokens', 'text', "
        "'prompt'/'completion', or 'messages' fields"
    )


def pack_documents(
    docs: Sequence[Document | Sequence[int]], seq_len: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate docs → (n_blocks, seq_len) token, segment-id, and
    loss-flag arrays. Accepts bare token lists (all positions count) or
    (tokens, flags) documents (SFT completion masking)."""
    stream: list[int] = []
    segs: list[int] = []
    flags: list[int] = []
    for i, d in enumerate(docs):
        if isinstance(d, tuple):
            toks, f = d
        else:
            toks, f = list(d), [1] * len(d)
        if len(f) != len(toks):
            raise ValueError(f"doc {i}: {len(f)} flags for {len(toks)} tokens")
        stream.extend(toks)
        flags.extend(f)
        segs.extend([i + 1] * len(toks))
    n_blocks = max(len(stream) // seq_len, 1)
    if len(stream) < seq_len:  # pad tiny datasets up to one block
        pad = seq_len - len(stream)
        stream = list(stream) + [0] * pad
        segs = list(segs) + [0] * pad
        flags = list(flags) + [0] * pad
    cut = n_blocks * seq_len
    tokens = np.asarray(stream[:cut], np.int32).reshape(n_blocks, seq_len)
    segments = np.asarray(segs[:cut], np.int32).reshape(n_blocks, seq_len)
    loss_flags = np.asarray(flags[:cut], np.float32).reshape(n_blocks, seq_len)
    return tokens, segments, loss_flags


def batches_from_tokens(
    tokens: np.ndarray,
    segments: np.ndarray | None,
    batch_size: int,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
    loss_flags: np.ndarray | None = None,
) -> Iterator[dict]:
    """Infinite shuffled batch iterator over packed blocks."""
    n = tokens.shape[0]
    rng = np.random.default_rng(seed)

    def make_batch(idx: np.ndarray) -> dict:
        if segments is None:
            mask = (
                loss_flags[idx].astype(np.float32)
                if loss_flags is not None
                else np.ones_like(tokens[idx], np.float32)
            )
            return {"tokens": tokens[idx], "loss_mask": mask}
        seg = segments[idx]
        # Mask padding AND each document's first in-block token: predicting
        # doc i+1's first token happens from inside doc i, which
        # segment-masked attention cannot see — irreducible noise.  loss_mask
        # is indexed by *target* position (losses.next_token_loss), so the
        # zero goes on the boundary target itself.
        mask = (seg > 0).astype(np.float32)
        mask[:, 1:] *= (seg[:, 1:] == seg[:, :-1]).astype(np.float32)
        if loss_flags is not None:
            # SFT: only completion targets count
            mask *= loss_flags[idx].astype(np.float32)
        return {"tokens": tokens[idx], "loss_mask": mask, "segment_ids": seg}

    warned = False
    while True:
        order = rng.permutation(n)
        order = order[shard_index::shard_count]
        if not len(order):
            # Fewer blocks than hosts — unavoidable overlap; warn once.
            if not warned:
                logger.warning(
                    "dataset has %d blocks for %d shards; shard %d falls back "
                    "to the full block set (hosts will overlap)",
                    n, shard_count, shard_index,
                )
                warned = True
            order = rng.permutation(n)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            yield make_batch(order[i : i + batch_size])
        if len(order) < batch_size:
            # Shard smaller than one batch: tile this shard's own blocks.
            yield make_batch(np.resize(order, batch_size))


def jsonl_token_batches(
    path: str,
    batch_size: int,
    seq_len: int,
    tokenizer_file: str | None = None,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
) -> Iterator[dict]:
    tokens = segments = loss_flags = None
    if tokenizer_file is None and path.endswith(".jsonl"):
        # native C++ parse+tokenize+pack (data/native_loader.py): every
        # byte-level row schema, with loss flags, bit-equal to the Python
        # path; FTC_NATIVE=0 opts out.  A row it cannot own (malformed,
        # non-string chat content it would have to stringify) raises
        # ValueError and the Python loader decides — including raising the
        # user-facing error.  A build or load failure raises.
        from .native_loader import pack_jsonl_native

        try:
            packed = pack_jsonl_native(path, seq_len)
        except ValueError:
            packed = None
        if packed is not None:
            tokens, segments, loss_flags = packed
            logger.info("native packer produced %d blocks from %s", tokens.shape[0], path)
    if tokens is None:
        docs = load_token_documents(path, tokenizer_file)
        tokens, segments, loss_flags = pack_documents(docs, seq_len)
    return batches_from_tokens(
        tokens, segments, batch_size, seed=seed,
        shard_index=shard_index, shard_count=shard_count,
        loss_flags=loss_flags,
    )
