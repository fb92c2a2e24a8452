"""The fidelity proof on the CPU at the JAX CPU test's scale
(``tests/test_fidelity_e2e.py``: 120 pretraining steps on an 80 KB corpus,
80 SFT steps), through the port's controller (``fidelity.run_proof``, as
the reference's proof runs).

Nothing is mocked: real English text (stdlib docstrings), a full-mode
pretraining run exported as an HF directory, a LoRA SFT job from that
directory (submitted with ``task_builder``, trained by the local backend's
subprocess trainer ``train/cli.py``, read by the monitor and synced to the
object store), and greedy generation from the job's artifacts through
``models/generate_cli.py``.  The reference's three checks
hold: step-1 loss < 0.75 x random-init loss, final loss < 0.75 x step-1
loss, and the generation on a held-out topic starts with ``SFT_PREFIX``
after the job and not before.  ``build_corpus`` gives the reference's bytes.
"""

from __future__ import annotations

import json

import pytest
import torch

from finetune_controller_tpu.data import corpus as jax_corpus
from finetune_controller_tpu import fidelity as jax_fidelity
from finetune_controller_tpu_torch import fidelity
from finetune_controller_tpu_torch.data import corpus

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


@pytest.fixture(scope="module")
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)  # ~200 small CPU steps; restored below
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def base(threads, tmp_path_factory):
    base = fidelity.pretrain_base(tmp_path_factory.mktemp("fidelity") / "base",
                                  steps=PRETRAIN_STEPS, corpus_bytes=CORPUS_BYTES,
                                  batch_size=BATCH, seq_len=SEQ, device="cpu")
    # the base learned real English
    assert base["pretrain_final_loss"] < 0.7 * base["pretrain_first_loss"]
    return base


def test_fidelity_proof_through_the_port_cli(base, tmp_path):
    """The proof's fine-tune goes through the port's controller, whose local
    backend runs the port's CLI (``train/cli.py``) as the job's trainer."""
    record = fidelity.run_proof(tmp_path, sft_steps=SFT_STEPS, batch_size=BATCH, seq_len=SEQ,
                                lora_rank=RANK, max_new_tokens=MAX_NEW, base=base,
                                device="cpu", job_deadline_s=300.0)
    assert record["passed"], record
    assert len(record["after_generation"]) > 0
    fetched = tmp_path / "fetched_artifacts"
    assert (fetched / "done.txt").exists() and (fetched / "adapter").is_dir()
    assert json.loads((fetched / "fidelity_record.json").read_text())["passed"]
    assert (fetched / "adapter" / "adapter_config.json").exists()
