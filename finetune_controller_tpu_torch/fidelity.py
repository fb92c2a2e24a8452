"""Fidelity proof, first half: a real-weights, real-data fine-tune (the
port's counterpart of the reference's ``fidelity.py``, lines 1-248).

Every throughput number elsewhere runs on random weights and synthetic
tokens.  The proof checks the product instead:

1. **Pretrain a base** (:func:`pretrain_base`): ``tiny-test`` trained in
   full mode on real English (stdlib docstrings, ``data/corpus.py``; no
   network) until it models the text, exported through
   ``models/hf_export.py`` as an HF checkpoint directory — the stand-in for
   a pretrained base from the hub.
2. **Fine-tune** that base as a LoRA SFT job on the instruction rows of
   :func:`build_sft_jsonl`, whose completions open with :data:`SFT_PREFIX`.
3. **Check** that the step-0 loss from the base is far below the
   random-init loss, that the final loss is far below step 0, and that
   greedy generation on a HELD-OUT topic flips to the SFT style.

The reference's ``run_proof`` submits step 2 through its controller, which
the port does not have yet (ROADMAP Queue A item 3a); the port's proof
runs step 2 through ``train/cli.py`` and generates through
``models/generate_cli.py`` (``tests/test_torch_fidelity.py``, and phase F
of ``chip_smoke.py`` on the card).
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

#: SFT response style: every completion opens with this frame — trivially
#: learnable, unmistakably absent from stdlib-docstring English, so the
#: before/after generation contrast is unambiguous
SFT_PREFIX = "Aye, "

_TOPICS = [
    "the weather", "sailing ships", "buried treasure", "the open sea",
    "your parrot", "the captain", "a treasure map", "the island",
    "the crew", "the storm", "the harbor", "the compass", "the rigging",
    "the lookout", "the galley", "the anchor", "the tide", "the moon",
    "the cannons", "the flag",
]
#: topics never written to the SFT dataset — generation is probed on these
HOLDOUT_TOPICS = ["the kraken", "the lighthouse"]


def sft_prompt(topic: str) -> str:
    return f"<|user|>\nTell me about {topic}.\n<|assistant|>\n"


def sft_completion(topic: str) -> str:
    return f"{SFT_PREFIX}{topic} be a fine thing to know about, arr!\n"


def build_sft_jsonl(path: Path | str, *, rows_per_topic: int = 12) -> bytes:
    """Instruction rows (``prompt``/``completion`` — loss counts completion
    tokens only, ``data/loader.py``).  Returns the bytes written."""
    lines = []
    for r in range(rows_per_topic):
        for topic in _TOPICS:
            # vary the question frame so the learnable signal is the response
            # style, not one memorized byte sequence
            q = [
                f"<|user|>\nTell me about {topic}.\n<|assistant|>\n",
                f"<|user|>\nWhat do you know of {topic}?\n<|assistant|>\n",
                f"<|user|>\nDescribe {topic} for me.\n<|assistant|>\n",
            ][r % 3]
            lines.append(json.dumps(
                {"prompt": q, "completion": sft_completion(topic)}
            ))
    data = ("\n".join(lines) + "\n").encode()
    Path(path).write_bytes(data)
    return data


def _read_metrics_csv(path: Path) -> list[dict[str, float]]:
    with open(path) as f:
        return [
            {k: float(v) for k, v in row.items() if v != ""}
            for row in csv.DictReader(f)
        ]


def pretrain_base(
    work_dir: Path | str,
    *,
    steps: int = 600,
    corpus_bytes: int = 400_000,
    batch_size: int = 16,
    seq_len: int = 128,
    learning_rate: float = 1e-3,
    preset: str = "tiny-test",
    seed: int = 0,
    device=None,
) -> dict[str, Any]:
    """Pretrain ``preset`` on real English and export it as an HF checkpoint
    (one f32 ``model.safetensors`` + ``config.json``) on ``device`` (the
    CUDA card unless the caller passes another).

    Runs the trainer in ``full`` mode (no adapters — this *builds* the base
    the fine-tune will consume) and exports with
    ``export_merged_checkpoint``."""
    from .data.corpus import write_corpus_jsonl
    from .data.loader import jsonl_token_batches
    from .models.hf_export import export_merged_checkpoint
    from .models.llama import PRESETS
    from .train.trainer import TrainConfig, Trainer

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    corpus_path = work / "corpus.jsonl"
    n_bytes = write_corpus_jsonl(corpus_path, corpus_bytes)

    cfg = PRESETS[preset]
    tcfg = TrainConfig(
        mode="full",
        learning_rate=learning_rate,
        warmup_steps=min(20, max(1, steps // 20)),
        total_steps=steps,
        batch_size=batch_size,
        seq_len=seq_len,
        seed=seed,
        log_every=1,
        checkpoint_every=steps,  # only the final state matters here
    )
    trainer = Trainer(cfg, tcfg, device=device)
    batches = jsonl_token_batches(
        str(corpus_path), batch_size=batch_size, seq_len=seq_len, seed=seed
    )
    art = work / "pretrain_artifacts"
    trainer.fit(batches, str(art), resume=False)
    rows = _read_metrics_csv(art / "metrics.csv")
    first_loss, final_loss = rows[0]["loss"], rows[-1]["loss"]

    base_dir = work / "pretrained_base"
    export_merged_checkpoint(cfg, trainer.model.state_dict(), base_dir)
    logger.info(
        "pretrained base: loss %.3f -> %.3f over %d steps (%d corpus bytes) -> %s",
        first_loss, final_loss, steps, n_bytes, base_dir,
    )
    return {
        "base_dir": str(base_dir),
        "corpus_bytes": n_bytes,
        "pretrain_steps": steps,
        "pretrain_first_loss": first_loss,
        "pretrain_final_loss": final_loss,
    }


def _generate_text(model, prompt: str, max_new_tokens: int) -> str:
    """Greedy byte-level generation from ``model`` (KV-cached)."""
    import torch

    from .models.generate import cached_generate

    ids = list(prompt.encode())
    out = cached_generate(model, torch.tensor([ids]), max_new_tokens=max_new_tokens)
    new = out[0, len(ids):].tolist()
    return bytes(i for i in new if 0 <= i < 256).decode("utf-8", errors="replace")
