"""Post-finetune sanity generation from a job's artifacts directory (the
port's ``ftc-generate``, counterpart of the reference's
``models/generate_cli.py``).

``python -m finetune_controller_tpu_torch.models.generate_cli --artifacts DIR
--prompt "..." [--device cpu]`` rebuilds the trained model from the job
directory through ``serve/loader.load_trained_model`` (the job's
``resolved_config.json``, its seeded base, int4 ones included, or
``model.weights_dir``, and the latest checkpoint's trained tensors,
adapters left unmerged; an MoE or a LLaVA job too, as the reference rebuilds
it through its trainer), then decodes
with ``cached_generate`` (``generate`` with ``--oracle``).  A LLaVA job
needs ``--image`` (a path, a ``data:`` URI or bare base64, preprocessed as
its dataset's ``image_normalize`` says); a text job refuses one.  The flags and
the output JSON (``checkpoint_step``, ``prompt_tokens``, ``new_tokens``,
``text``) are the reference's.  Token IO uses the data pipeline's tokenizer
contract (``data/loader.py``): a HuggingFace ``tokenizers`` JSON file when
given, byte-level fallback otherwise.  The run is on the CUDA card unless
``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_token_list(raw: str) -> list[int]:
    try:
        return [int(t) for t in raw.replace(" ", "").split(",") if t]
    except ValueError:
        raise SystemExit(f"--prompt-tokens must be comma-separated ints, got {raw!r}")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="ftc-generate",
        description="Generate from a fine-tuned job's artifacts (sanity check)",
    )
    p.add_argument("--artifacts", required=True,
                   help="job artifacts dir (resolved_config.json + checkpoints/)")
    p.add_argument("--prompt", help="text prompt (tokenized per --tokenizer)")
    p.add_argument("--prompt-tokens",
                   help="comma-separated token ids (skips tokenization)")
    p.add_argument("--tokenizer",
                   help="HF tokenizers JSON file; default: byte-level fallback "
                        "(the data pipeline's convention)")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy (default)")
    p.add_argument("--top-k", type=int, default=0, help="0 = full distribution")
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--oracle", action="store_true",
                   help="uncached O(n^2) forward per token — the numerics "
                        "oracle; impractically slow past ~1B params")
    p.add_argument("--image",
                   help="image for multimodal jobs (path / data URI / "
                        "base64) — required for LLaVA-family artifacts")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    if (args.prompt is None) == (args.prompt_tokens is None):
        raise SystemExit("pass exactly one of --prompt or --prompt-tokens")

    spec_path = os.path.join(args.artifacts, "resolved_config.json")
    if not os.path.exists(spec_path):
        raise SystemExit(f"{spec_path} not found — is this a job artifacts dir?")
    with open(spec_path) as f:
        spec = json.load(f)

    from ..train.cli import build_model_config

    cfg = build_model_config(spec)
    multimodal = getattr(cfg, "vision", None) is not None
    if multimodal and not args.image:
        raise SystemExit(
            "this is a multimodal job's artifacts dir — pass --image "
            "(path / data URI / base64) for the image prefix"
        )
    if args.image and not multimodal:
        raise SystemExit("--image given but the job's model is text-only")

    # ---- tokenize ---------------------------------------------------------
    # an explicit --tokenizer always loads; otherwise --prompt mode uses the
    # tokenizer the JOB trained with (dataset.tokenizer_file), with the byte
    # fallback only when the job itself trained on it.  Token-id mode never
    # touches the spec's tokenizer: ids in, ids out.
    tok_file = args.tokenizer
    if tok_file is None and args.prompt is not None:
        tok_file = spec.get("dataset", {}).get("tokenizer_file")
    tokenizer = None
    if tok_file:
        from tokenizers import Tokenizer

        try:
            tokenizer = Tokenizer.from_file(tok_file)
        except Exception as e:
            raise SystemExit(
                f"could not load tokenizer {tok_file!r} ({e}) — pass "
                "--tokenizer with a local path, or --prompt-tokens to skip "
                "tokenization"
            )
    if args.prompt_tokens is not None:
        ids = _parse_token_list(args.prompt_tokens)
    elif tokenizer is not None:
        ids = tokenizer.encode(args.prompt).ids
    else:
        from ..data.loader import _byte_tokenize

        ids = _byte_tokenize(args.prompt)
    if not ids:
        raise SystemExit("empty prompt")
    bad = [i for i in ids if not 0 <= i < cfg.vocab_size]
    if bad:
        raise SystemExit(
            f"prompt ids {bad[:5]} out of range for vocab {cfg.vocab_size}"
        )

    # ---- rebuild the trained model (the resume recipe) --------------------
    import torch

    from ..serve.loader import ServeLoadError, load_trained_model
    from .generate import cached_generate, generate

    try:
        model, meta = load_trained_model(args.artifacts, device=args.device)
    except ServeLoadError as e:
        raise SystemExit(str(e))
    prefix = cfg.vision.n_patches if multimodal else 0
    if prefix + len(ids) + args.max_new_tokens > cfg.max_seq_len:
        print(
            f"warning: image prefix ({prefix}) + prompt ({len(ids)}) + "
            f"max_new_tokens ({args.max_new_tokens}) exceeds the model's "
            f"trained max_seq_len ({cfg.max_seq_len}) — RoPE positions past "
            "the trained range degrade quality",
            file=sys.stderr,
        )
    gen_kw: dict = {}
    if multimodal:
        from ..data.images import preprocess_image

        gen_kw["pixels"] = torch.from_numpy(preprocess_image(
            args.image, cfg.image_size,
            normalize=spec.get("dataset", {}).get("image_normalize", "clip"),
        ))[None]
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    gen_fn = generate if args.oracle else cached_generate
    out = gen_fn(
        model, torch.tensor([ids]), max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
        generator=gen, **gen_kw,
    )
    new_ids = out[0, len(ids):].tolist()
    if args.eos_id is not None and args.eos_id in new_ids:
        new_ids = new_ids[: new_ids.index(args.eos_id)]

    if tokenizer is not None:
        text = tokenizer.decode(new_ids)
    elif args.prompt is not None:
        text = bytes(i for i in new_ids if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )
    else:
        text = None  # token-id mode: ids in, ids out
    print(json.dumps({
        "checkpoint_step": meta["checkpoint_step"],
        "prompt_tokens": len(ids),
        "new_tokens": new_ids,
        "text": text,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
