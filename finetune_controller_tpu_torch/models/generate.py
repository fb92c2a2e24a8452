"""Sampling: the shared token-selection rule and the uncached oracle.

Counterpart of the reference's ``models/generate.py``:

* :func:`_sample` — greedy argmax, or temperature and top-k then a
  categorical draw from an explicit ``torch.Generator``;
* :func:`generate` — the numerics oracle: each step re-runs the full
  forward over the sequence so far (no KV cache); :func:`greedy_generate`
  is its greedy form;
* :func:`cached_generate` — fill then decode over a dense KV cache of
  ``prompt_len + max_new_tokens`` positions (``LlamaForCausalLM.
  forward_cached``), one single-position forward per new token.

A multimodal model (``models/multimodal.LlavaForCausalLM``) takes
``pixels``: the oracle re-encodes the image every step; the cached path
fills over ``[image; text]``, sizes the cache ``n_patches + prompt_len +
max_new_tokens`` and offsets the decode positions by ``n_patches``.

Sampled streams cannot match the reference's: JAX draws with threefry keys,
PyTorch with Philox generators.  Determinism is pinned inside the port
instead — the same seed gives the same tokens.
"""

from __future__ import annotations

import torch

from .llama import DenseKV


def _sample(logits: torch.Tensor, *, temperature: float, top_k: int,
            generator: torch.Generator | None) -> torch.Tensor:
    """Next tokens (B,) from (B, V) logits; ``generator`` advances in place.

    A draw is ``torch.multinomial(probs, 1)``'s own one-sample path written
    out (the argmax of ``probs`` over exponential noise from ``generator``):
    the same tokens from the same generator state, without the host read
    ``multinomial`` makes to check its input, so a decode step samples
    with no device<->host sync."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    probs = torch.softmax(scaled, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


def _image_kw(model, pixels) -> dict:
    """The model's ``pixels`` keyword, on its device; the reference's
    refusals of a multimodal model without pixels and a text model with
    them (a silently dropped image would give plausible text that never
    saw it)."""
    multimodal = getattr(model.cfg, "vision", None) is not None
    if multimodal and pixels is None:
        raise ValueError("multimodal generation needs pixels=")
    if pixels is not None and not multimodal:
        raise ValueError("pixels= given but the model is text-only")
    if pixels is None:
        return {}
    return {"pixels": torch.as_tensor(pixels, dtype=torch.float32, device=model.device)}


@torch.no_grad()
def generate(model, prompt_tokens: torch.Tensor, *, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: int = 0, eos_id: int | None = None,
             generator: torch.Generator | None = None,
             pixels: torch.Tensor | None = None) -> torch.Tensor:
    """Autoregressive sampling with a full forward per step; returns
    (B, S + max_new_tokens) tokens.  Rows that emit ``eos_id`` keep
    emitting it.  ``pixels`` (B, H, W, 3) feeds a multimodal model's image
    prefix."""
    image = _image_kw(model, pixels)
    tokens = torch.as_tensor(prompt_tokens, dtype=torch.long, device=model.device)
    if tokens.ndim != 2:
        raise ValueError(f"prompt_tokens must be (B, S), got {tuple(tokens.shape)}")
    done = torch.zeros(tokens.shape[0], dtype=torch.bool, device=tokens.device)
    for _ in range(max_new_tokens):
        logits = model(tokens, **image)[:, -1].to(torch.float32)
        nxt = _sample(logits, temperature=temperature, top_k=top_k, generator=generator)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens


def greedy_generate(model, prompt_tokens: torch.Tensor, *, max_new_tokens: int = 32,
                    eos_id: int | None = None) -> torch.Tensor:
    """:func:`generate` with greedy selection (the reference's
    ``greedy_generate``, ``generate.py:90-95``)."""
    return generate(model, prompt_tokens, max_new_tokens=max_new_tokens, temperature=0.0,
                    eos_id=eos_id)


@torch.no_grad()
def cached_generate(model, prompt_tokens: torch.Tensor, *, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_k: int = 0, eos_id: int | None = None,
                    generator: torch.Generator | None = None,
                    pixels: torch.Tensor | None = None) -> torch.Tensor:
    """KV-cached fill-then-decode sampling; the contract of :func:`generate`
    (the reference's ``cached_generate``, ``generate.py:158-227``).  Every
    row decodes in lockstep at the same position; a multimodal model's
    image prefix occupies the cache's first ``n_patches`` slots."""
    image = _image_kw(model, pixels)
    tokens = torch.as_tensor(prompt_tokens, dtype=torch.long, device=model.device)
    if tokens.ndim != 2:
        raise ValueError(f"prompt_tokens must be (B, S), got {tuple(tokens.shape)}")
    b, prompt_len = tokens.shape
    prefix = model.cfg.vision.n_patches if image else 0
    fill = prefix + prompt_len
    kv = DenseKV.zeros(model.text_cfg, b, fill + max_new_tokens, model.device)
    positions = torch.arange(fill, device=tokens.device).expand(b, fill)
    index = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    logits = model.forward_cached(tokens, positions, kv, index, fresh=True,
                                  last_idx=fill - 1, **image).to(torch.float32)
    done = torch.zeros((b,), dtype=torch.bool, device=tokens.device)
    for t in range(max_new_tokens):
        nxt = _sample(logits, temperature=temperature, top_k=top_k, generator=generator)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        if t == max_new_tokens - 1:
            break
        pos = fill + t
        logits = model.forward_cached(
            nxt[:, None], torch.full((b, 1), pos, device=tokens.device), kv,
            torch.full((b,), pos, dtype=torch.int32, device=tokens.device), last_idx=0,
        ).to(torch.float32)
    return tokens
