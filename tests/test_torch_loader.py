"""The port's checkpoint loader against the trainer that wrote the
checkpoint and against the JAX package's loader.

The port's CLI trains ``tiny-test`` (f32, LoRA rank 4) for 2 steps on the
CPU; ``load_serving_model`` then rebuilds the model from the job directory:

* unmerged, its logits EQUAL the trainer's own (the trainer restored from
  the same checkpoint); merged, they agree within 1e-5 (f32 reassociation),
  and equal the reference's ``merge_lora_variables`` model on the same
  tensors within 1e-5;
* ``strip_lora_for_multitenant`` and ``_load_adapter_tree`` give the job's
  own adapter, which served as a tenant on the base decodes the merged
  model's greedy tokens;
* the refusals (no spec, no checkpoint, no committed step, a rank-0 job for
  the adapter path) carry the reference loader's messages, word for word.
"""

from __future__ import annotations

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.serve import loader as jax_loader
from finetune_controller_tpu_torch.models.convert import to_flax
from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, GenRequest
from finetune_controller_tpu_torch.serve.loader import (
    ServeLoadError,
    _load_adapter_tree,
    _resolve_staged_spec,
    load_serving_model,
    stage_meta,
    strip_lora_for_multitenant,
)
from finetune_controller_tpu_torch.train import cli
from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager
from finetune_controller_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

SPEC = {
    "job_id": "loader-test",
    "model": {"preset": "tiny-test", "lora": {"rank": 4, "alpha": 8.0},
              "overrides": {"dtype": "float32"}},
    "training": {"total_steps": 2, "batch_size": 4, "seq_len": 16, "log_every": 1,
                 "checkpoint_every": 2, "warmup_steps": 1, "learning_rate": 0.05, "seed": 3},
    "dataset": {"synthetic": {"task": "increment"}},
}
TOKENS = torch.tensor([[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5, 4, 3]])


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A trained job directory: the port's CLI, 2 steps on the CPU."""
    art = tmp_path_factory.mktemp("job")
    spec = {**SPEC, "artifacts_dir": str(art)}
    (art / "job.json").write_text(json.dumps(spec))
    assert cli.main(["--spec", str(art / "job.json"), "--device", "cpu"]) == 0
    return art


@pytest.fixture(scope="module")
def trainer_logits(job):
    """The trainer's own logits: a Trainer of the job restored from its
    last checkpoint."""
    trainer = Trainer(cli.build_model_config(SPEC), cli.build_train_config(SPEC), device="cpu")
    trainer.load_state(CheckpointManager(job / "checkpoints").restore(2))
    trainer.model.eval()
    with torch.no_grad():
        return trainer.model(TOKENS)


def test_load_unmerged_and_merged_reproduce_the_trainer(job, trainer_logits):
    unmerged, meta = load_serving_model(job, merge_lora=False, device="cpu")
    merged, mmeta = load_serving_model(job, merge_lora=True, device="cpu")
    assert meta["checkpoint_step"] == mmeta["checkpoint_step"] == 2
    assert (meta["lora_merged"], mmeta["lora_merged"]) == (False, True)
    assert merged.cfg.lora.rank == 0 and unmerged.cfg.lora.rank == 4
    assert not any(k.endswith(".lora_a") for k in merged.state_dict())
    with torch.no_grad():
        assert torch.equal(unmerged(TOKENS), trainer_logits)
        np.testing.assert_allclose(merged(TOKENS).numpy(), trainer_logits.numpy(),
                                   atol=1e-5, rtol=1e-5)
    # the reference's merge of the same tensors gives the same model
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32,
                                            lora=JaxLoRAConfig(rank=4, alpha=8.0))
    mcfg, mvars = jax_loader.merge_lora_variables(
        jcfg, to_flax(unmerged.state_dict(), unmerged.cfg.replace(scan_layers=True)))
    want = JaxLlama(mcfg).apply(mvars, jnp.asarray(TOKENS.numpy(), jnp.int32))
    with torch.no_grad():
        np.testing.assert_allclose(merged(TOKENS).numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_job_adapter_served_as_a_tenant_matches_the_merged_model(job):
    """The job's own adapter — stripped from the unmerged model, or read
    alone from the directory — served as tenant #1 on the pristine base
    decodes the merged model's greedy tokens."""
    unmerged, _ = load_serving_model(job, merge_lora=False, device="cpu")
    base, adapter, alpha, rank = strip_lora_for_multitenant(unmerged)
    assert (alpha, rank) == (8.0, 4) and base.cfg.lora.rank == 0
    assert base.embed_tokens.embedding.data_ptr() == unmerged.embed_tokens.embedding.data_ptr()
    tree, meta = _load_adapter_tree(job)
    assert sorted(tree) == sorted(adapter) and len(tree) == 2 * 7 * 2
    assert all(torch.equal(tree[k], adapter[k]) for k in tree)
    assert (meta["lora_rank"], meta["lora_alpha"], meta["checkpoint_step"]) == (4, 8.0, 2)
    merged, _ = load_serving_model(job, merge_lora=True, device="cpu")
    cfg = dict(slots=2, prompt_buckets=(8, 16), max_new_tokens=8, page_tokens=4)
    engine = BatchEngine(base, EngineConfig(**cfg, tenant_slots=2, tenant_rank=8))
    engine.adapters.register("job", tree, alpha, rank)
    engine.install_adapter("job")
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    got = engine.run([GenRequest(f"p{i}", p, 8, adapter_id="job")
                      for i, p in enumerate(prompts)])
    want = BatchEngine(merged, EngineConfig(**cfg)).run(
        [GenRequest(f"p{i}", p, 8) for i, p in enumerate(prompts)])
    assert {k: r.generated for k, r in got.items()} == {k: r.generated for k, r in want.items()}
    assert stage_meta(job, merge_lora=False)["lora_merged"] is False


def _reference_error(fn, path):
    with pytest.raises(jax_loader.ServeLoadError) as info:
        fn(path)
    return str(info.value)


def _refusal_dirs(job, root):
    """Job directories the loader must refuse: no spec, no checkpoint, no
    committed step, and a rank-0 job (for the adapter path)."""
    (root / "empty").mkdir()
    (root / "no_ckpt").mkdir()
    shutil.copy(job / "resolved_config.json", root / "no_ckpt")
    (root / "uncommitted" / "checkpoints" / ".step_2.tmp-1").mkdir(parents=True)
    shutil.copy(job / "resolved_config.json", root / "uncommitted")
    (root / "rank0").mkdir()
    spec = json.loads((job / "resolved_config.json").read_text())
    spec["model"]["lora"] = {"rank": 0}
    (root / "rank0" / "resolved_config.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("case, which", [
    ("empty", "spec"), ("no_ckpt", "spec"), ("uncommitted", "spec"),
    ("empty", "adapter"), ("no_ckpt", "adapter"), ("rank0", "adapter"),
])
def test_refusals_carry_the_reference_messages(job, tmp_path, case, which):
    """Each refusal of the port's loader is the reference loader's, word
    for word, for the same directory."""
    _refusal_dirs(job, tmp_path)
    port_fn, ref_fn = {"spec": (_resolve_staged_spec, jax_loader._resolve_staged_spec),
                       "adapter": (_load_adapter_tree, jax_loader._load_adapter_tree)}[which]
    with pytest.raises(ServeLoadError) as info:
        port_fn(tmp_path / case)
    assert str(info.value) == _reference_error(ref_fn, tmp_path / case)
    assert info.value.status == 409
    if case == "empty":
        with pytest.raises(ServeLoadError, match="no job spec"):
            load_serving_model(tmp_path / case, device="cpu")
