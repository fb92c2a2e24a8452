"""The fidelity proof through the port's CLI, on the CPU, at the JAX CPU
test's scale (``tests/test_fidelity_e2e.py``: 120 pretraining steps on an
80 KB corpus, 80 SFT steps).

Nothing is mocked: real English text (stdlib docstrings), a full-mode
pretraining run exported as an HF directory, a LoRA SFT job from that
directory through ``train/cli.py``, and greedy generation from the job's
artifacts through ``models/generate_cli.py``.  The reference's three checks
hold: step-1 loss < 0.75 x random-init loss, final loss < 0.75 x step-1
loss, and the generation on a held-out topic starts with ``SFT_PREFIX``
after the job and not before.  ``build_corpus`` gives the reference's bytes.
"""

from __future__ import annotations

import contextlib
import io
import json

import torch

from finetune_controller_tpu.data import corpus as jax_corpus
from finetune_controller_tpu import fidelity as jax_fidelity
from finetune_controller_tpu_torch import fidelity
from finetune_controller_tpu_torch.data import corpus
from finetune_controller_tpu_torch.data.loader import jsonl_token_batches
from finetune_controller_tpu_torch.models import generate_cli
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.train import cli
from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

PRETRAIN_STEPS, CORPUS_BYTES, SFT_STEPS = 120, 80_000, 80
BATCH, SEQ, RANK, MAX_NEW = 16, 128, 8, 24


def test_corpus_and_sft_rows_equal_the_reference(tmp_path):
    assert corpus.build_corpus(CORPUS_BYTES) == jax_corpus.build_corpus(CORPUS_BYTES)
    assert corpus.write_corpus_jsonl(tmp_path / "a.jsonl", 20_000) == \
        jax_corpus.write_corpus_jsonl(tmp_path / "b.jsonl", 20_000)
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()
    assert fidelity.build_sft_jsonl(tmp_path / "a.sft") == \
        jax_fidelity.build_sft_jsonl(tmp_path / "b.sft")
    assert (fidelity.SFT_PREFIX, fidelity.HOLDOUT_TOPICS) == \
        (jax_fidelity.SFT_PREFIX, jax_fidelity.HOLDOUT_TOPICS)
    assert fidelity.sft_prompt("x") == jax_fidelity.sft_prompt("x")


def test_fidelity_proof_through_the_port_cli(tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # ~200 small CPU steps; restored below
    try:
        _proof(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _proof(tmp_path):
    base = fidelity.pretrain_base(tmp_path / "base", steps=PRETRAIN_STEPS,
                                  corpus_bytes=CORPUS_BYTES, batch_size=BATCH, seq_len=SEQ,
                                  device="cpu")
    # the base learned real English
    assert base["pretrain_final_loss"] < 0.7 * base["pretrain_first_loss"]
    sft = tmp_path / "sft.jsonl"
    fidelity.build_sft_jsonl(sft)
    probe = fidelity.sft_prompt(fidelity.HOLDOUT_TOPICS[0])

    # the reference losses and the "before" generation: fresh adapters
    # (B = 0) are the base's behaviour
    trainer = Trainer(PRESETS["tiny-test"].replace(lora=LoRAConfig(rank=RANK)),
                      TrainConfig(mode="lora", batch_size=BATCH, seq_len=SEQ, eval_steps=4),
                      device="cpu")

    def eval_loss() -> float:
        batches = jsonl_token_batches(str(sft), batch_size=BATCH, seq_len=SEQ, seed=7)
        return trainer.evaluate(batches)["eval_loss"]

    random_init_loss = eval_loss()
    trainer.load_pretrained(base["base_dir"])
    assert eval_loss() < 0.75 * random_init_loss
    before = fidelity._generate_text(trainer.model, probe, MAX_NEW)

    # the SFT job through the CLI, from the exported base
    art = tmp_path / "job"
    spec = {"job_id": "fidelity-1",
            "model": {"preset": "tiny-test", "weights_dir": base["base_dir"],
                      "lora": {"rank": RANK}},
            "training": {"mode": "lora", "learning_rate": 3e-3, "total_steps": SFT_STEPS,
                         "warmup_steps": max(1, SFT_STEPS // 20), "batch_size": BATCH,
                         "seq_len": SEQ, "log_every": 1, "checkpoint_every": 100},
            "dataset": {"path": str(sft)}, "artifacts_dir": str(art)}
    (tmp_path / "job.json").write_text(json.dumps(spec))
    assert cli.main(["--spec", str(tmp_path / "job.json"), "--device", "cpu"]) == 0
    rows = fidelity._read_metrics_csv(art / "metrics.csv")
    step0_loss, final_loss = rows[0]["loss"], rows[-1]["loss"]

    # the "after" generation from the job's artifacts (the operator surface)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert generate_cli.main(["--artifacts", str(art), "--prompt", probe,
                                  "--max-new-tokens", str(MAX_NEW), "--device", "cpu"]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["checkpoint_step"] == SFT_STEPS and len(out["new_tokens"]) == MAX_NEW
    after = out["text"]

    checks = {
        "base_transfers": step0_loss < 0.75 * random_init_loss,
        "finetune_learns": final_loss < 0.75 * step0_loss,
        "style_acquired": after.startswith(fidelity.SFT_PREFIX)
        and not before.startswith(fidelity.SFT_PREFIX),
    }
    assert all(checks.values()), (checks, random_init_loss, step0_loss, final_loss,
                                  before, after)
    assert (art / "adapter" / "adapter_config.json").exists()
