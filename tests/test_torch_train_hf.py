"""Training from a pretrained HF directory, held-out evaluation and the
exports, in the port against the JAX trainer on the same files and
batches.

The HF directory is the port's own export of a seeded ``tiny-test`` (f32),
so no ``transformers`` model is built here.

* the port's CLI trains 2 steps from it (``model.weights_dir``), evaluating
  every step on ``dataset.eval_path``, and writes ``adapter/`` and
  ``merged/``;
* the step-1 loss of the port's ``Trainer`` after ``load_pretrained``
  equals the JAX trainer's on the same directory and batch, rel 1e-5, in
  lora and in full mode;
* ``evaluate`` equals the JAX ``evaluate`` on the same batches and the same
  non-zero adapters, rel 1e-5, microbatched in 2;
* ``load_serving_model`` of the CLI's job, base from ``weights_dir``, gives
  the trainer's logits (equal unmerged, 1e-5 merged);
* the guard fields raise naming their ROADMAP item, and the eval-split
  error is the reference's, word for word;
* ``prefetch_to_device`` hands the step the batches the inline copy makes,
  and a run with it equals a run without.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.train import cli as jax_cli
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu.train.trainer import Trainer as JaxTrainer
from finetune_controller_tpu_torch.data.prefetch import PrefetchIterator
from finetune_controller_tpu_torch.models.convert import from_flax
from finetune_controller_tpu_torch.models.hf_export import export_merged_checkpoint
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM, init_random_
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.serve.loader import load_serving_model
from finetune_controller_tpu_torch.train import cli
from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager
from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

SEQ = 16
TOKENS = torch.tensor([[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5, 4, 3]])


def _write_text(path, seed: int, n: int = 40) -> None:
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "sea", "ship", "the", "a", "of", "to"]
    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps({"text": " ".join(rng.choice(words, rng.integers(3, 12)))}) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """An HF directory (the port's export of a seeded tiny-test) and a
    train and an eval text file."""
    root = tmp_path_factory.mktemp("hf")
    model = LlamaForCausalLM(PRESETS["tiny-test"], device="cpu")
    init_random_(model, 5)
    export_merged_checkpoint(model.cfg, model.state_dict(), root / "base")
    _write_text(root / "train.jsonl", 1)
    _write_text(root / "eval.jsonl", 2)
    return root


def _spec(files, art, **training) -> dict:
    return {
        "job_id": "hf-test",
        "model": {"preset": "tiny-test", "weights_dir": str(files / "base"),
                  "lora": {"rank": 4, "alpha": 8.0}, "overrides": {"dtype": "float32"}},
        "training": {"total_steps": 2, "batch_size": 4, "seq_len": SEQ, "log_every": 1,
                     "checkpoint_every": 2, "warmup_steps": 1, "learning_rate": 0.05,
                     "seed": 3, "eval_every": 1, "eval_steps": 2, "export_merged": True,
                     **training},
        "dataset": {"path": str(files / "train.jsonl"), "eval_path": str(files / "eval.jsonl")},
        "artifacts_dir": str(art),
    }


@pytest.fixture(scope="module")
def job(files, tmp_path_factory):
    art = tmp_path_factory.mktemp("job")
    spec = _spec(files, art)
    (art / "job.json").write_text(json.dumps(spec))
    assert cli.main(["--spec", str(art / "job.json"), "--device", "cpu"]) == 0
    return art, spec


def test_cli_trains_from_hf_dir_evaluates_and_exports(job):
    import csv

    art, _ = job
    with open(art / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r["eval_loss"])) and float(r["eval_input_ms"]) >= 0
               for r in rows)
    assert sorted(p.name for p in (art / "adapter").iterdir()) == [
        "adapter_config.json", "adapter_model.safetensors"]
    assert sorted(p.name for p in (art / "merged").iterdir()) == [
        "config.json", "model.safetensors"]
    assert json.loads((art / "adapter" / "adapter_config.json").read_text())["r"] == 4
    assert (art / "done.txt").exists()


def _batch(seed: int, rows: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    mask = (rng.random((rows, SEQ)) > 0.2).astype(np.float32)
    return {"tokens": rng.integers(0, 256, (rows, SEQ)).astype(np.int32), "loss_mask": mask}


def _jax_trainer(mode: str, **kw):
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32,
                                            lora=JaxLoRAConfig(rank=4 if mode == "lora" else 0,
                                                               alpha=8.0))
    return JaxTrainer(jcfg, JaxTrainConfig(mode=mode, batch_size=4, seq_len=SEQ,
                                           learning_rate=0.05, warmup_steps=1, total_steps=2,
                                           prefetch=0, **kw))


def _port_trainer(mode: str, **kw) -> Trainer:
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32,
                                       lora=LoRAConfig(rank=4 if mode == "lora" else 0,
                                                       alpha=8.0))
    return Trainer(cfg, TrainConfig(mode=mode, batch_size=4, seq_len=SEQ, learning_rate=0.05,
                                    warmup_steps=1, total_steps=2, prefetch=0, **kw),
                   device="cpu")


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_step_one_loss_equals_the_jax_trainer_from_the_same_dir(files, mode):
    """Fresh adapters have B = 0 (and full mode has none), so the first
    step's loss is the pretrained base's on both sides."""
    batch = _batch(11)
    jtrainer = _jax_trainer(mode)
    state = jtrainer.load_pretrained(jtrainer.init_state(), str(files / "base"))
    _, want = jtrainer.step(state, dict(batch))
    trainer = _port_trainer(mode)
    trainer.load_pretrained(str(files / "base"))
    got = trainer.step(dict(batch))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"].item(), float(want["accuracy"]), rtol=1e-5)


def test_evaluate_equals_the_jax_evaluate(files):
    """The pretrained base with the same non-zero adapters on both sides,
    ``eval_steps`` 3 batches of 4 rows in 2 microbatches each."""
    jtrainer = _jax_trainer("lora", eval_steps=3, grad_accum_steps=2)
    state = jtrainer.load_pretrained(jtrainer.init_state(), str(files / "base"))
    rng = np.random.default_rng(9)
    lora = jax.tree_util.tree_map(
        lambda x: np.asarray(0.05 * rng.standard_normal(x.shape), np.float32),
        jax.device_get(state.trainable))
    state = state.replace(trainable=lora)
    batches = [_batch(20 + i) for i in range(3)]
    want = jtrainer.evaluate(state, iter([dict(b) for b in batches]))
    trainer = _port_trainer("lora", eval_steps=3, grad_accum_steps=2)
    trainer.load_pretrained(str(files / "base"))
    frozen = jax.device_get(state.frozen)
    trainer.model.load_state_dict(from_flax({**frozen, "lora": lora}, trainer.model.cfg))
    got = trainer.evaluate(iter([dict(b) for b in batches]))
    assert trainer.model.training
    assert sorted(got) == sorted(want) == ["eval_accuracy", "eval_input_ms", "eval_loss"]
    for key in ("eval_loss", "eval_accuracy"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_loader_with_weights_dir_gives_the_trainer_logits(job):
    art, spec = job
    trainer = Trainer(cli.build_model_config(spec), cli.build_train_config(spec), device="cpu")
    trainer.load_pretrained(spec["model"]["weights_dir"])
    trainer.load_state(CheckpointManager(art / "checkpoints").restore(2))
    trainer.model.eval()
    unmerged, meta = load_serving_model(art, merge_lora=False, device="cpu")
    merged, _ = load_serving_model(art, merge_lora=True, device="cpu")
    assert meta["weights_dir"] == spec["model"]["weights_dir"]
    with torch.no_grad():
        want = trainer.model(TOKENS)
        assert torch.equal(unmerged(TOKENS), want)
        np.testing.assert_allclose(merged(TOKENS).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("field,value,what", [
    ("shard_audit", "raise", "shard audit"),
])
def test_guard_fields_raise_naming_their_item(field, value, what):
    with pytest.raises(NotImplementedError, match=f"{what} \\(ROADMAP Queue A item 9\\)"):
        _port_trainer("lora", **{field: value})


def test_eval_split_error_matches_the_reference(files, tmp_path):
    spec = _spec(files, tmp_path / "art")
    del spec["dataset"]["eval_path"]
    spec["model"].pop("weights_dir")
    with pytest.raises(ValueError) as want:
        jax_cli.run_job(json.loads(json.dumps(spec)))
    with pytest.raises(ValueError) as got:
        cli.run_job(spec, "cpu")
    assert str(got.value) == str(want.value)
    assert "no eval split" in str(got.value)


def test_prefetch_to_device_gives_the_inline_batches(files, tmp_path):
    trainer = _port_trainer("lora")
    batches = [_batch(30 + i) for i in range(3)]
    staged = list(PrefetchIterator(iter(batches), depth=2,
                                   transfer=trainer._transfer_stage()))
    for got, batch in zip(staged, batches):
        want = trainer._to_device(batch)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key])
    rows = {}
    for on in (True, False):
        spec = _spec(files, tmp_path / str(on), prefetch_to_device=on, export_merged=False)
        cli.run_job(spec, "cpu")
        with open(tmp_path / str(on) / "metrics.csv") as f:
            rows[on] = [line.split(",")[2] for line in f.read().splitlines()[1:]]
    assert rows[True] == rows[False]
