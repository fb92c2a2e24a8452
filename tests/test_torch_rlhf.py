"""The port's RLHF-lite loop, the preference jobs through the CLI, and the
loader serving them, on the CPU.

* ``RolloutActor`` at ``temperature=0`` against the JAX actor on the same
  ``tiny-test`` weights (f32): the same pairs (prompt, chosen, rejected,
  version, rewards) from the adapterless start and after the port's actor
  reloads a committed checkpoint (the JAX actor installs the same adapter);
  the learner's base tensors are unchanged by the reload (bit for bit) and
  the engine's merged kernels are storage of their own; a push-mode actor
  given the same adapter through ``install_policy`` gives the same pairs;
* ``dpo``, ``reward`` and ``rlhf`` jobs through ``train.cli.main --device
  cpu``: their metrics columns, checkpoints, ``done.txt`` and the PEFT
  adapter; the rlhf rows track the committed step one round behind; the
  reward job's ``reward_head.msgpack`` reads back with ``w`` of shape
  ``(V,)``;
* ``load_serving_model`` serves each job (a reward job's checkpoint carries
  the head, which the reward trainer restores and the served model leaves
  out): unmerged logits equal the job's trainer restored from the same
  checkpoint, and the engine answers.
"""

from __future__ import annotations

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.prefs import actor as jax_actor
from finetune_controller_tpu.prefs.dpo_trainer import DPOTrainer as JaxDPOTrainer
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu_torch.models.convert import from_flax
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.prefs import actor
from finetune_controller_tpu_torch.prefs.dpo_trainer import DPOTrainer
from finetune_controller_tpu_torch.prefs.learner import RolloutConfig
from finetune_controller_tpu_torch.prefs.reward_trainer import read_reward_head
from finetune_controller_tpu_torch.serve.engine import GenRequest
from finetune_controller_tpu_torch.serve.loader import load_serving_model
from finetune_controller_tpu_torch.train import cli
from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager
from finetune_controller_tpu_torch.train.trainer import TrainConfig

torch.set_num_threads(1)

SEQ, VOCAB, NEW = 16, 256, 6


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32), tree)


def _pairs(pairs):
    return [(p.prompt, p.chosen, p.rejected, p.version, p.reward_chosen, p.reward_rejected)
            for p in pairs]


def _oracle(p, n):
    return [(p[-1] + 1 + i) % VOCAB for i in range(n)]


@pytest.fixture(scope="module")
def actors(tmp_path_factory):
    """Both actors' pairs from the step-0 policy and after a reload of the
    step-5 adapter, and the port learner's base before and after."""
    kw = dict(task="rlhf", batch_size=2, seq_len=SEQ, total_steps=2, prefetch=0)
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxDPOTrainer(jcfg, JaxTrainConfig(**kw))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 31)
    lora = _noisy(jax.device_get(state.trainable), 32)
    settings = dict(prompt_bucket=8, max_new_tokens=NEW, temperature=0.0, slots=2, seed=3)
    jact = jax_actor.RolloutActor(
        jtrainer.model, frozen["params"], None,
        reward_fn=lambda p, c: jax_actor.increment_reward(p, c, VOCAB),
        prompts=jax_actor.increment_prompts(SEQ, VOCAB, 7919), oracle_fn=_oracle, **settings)

    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))
    trainer = DPOTrainer(cfg, TrainConfig(**kw), device="cpu")
    zero = jax.tree_util.tree_map(np.zeros_like, lora)
    trainer.model.load_state_dict(from_flax({**frozen, "lora": zero}, cfg))
    ckpt_dir = tmp_path_factory.mktemp("actor") / "checkpoints"
    pact = actor.RolloutActor(
        trainer.model, str(ckpt_dir),
        reward_fn=lambda p, c: actor.increment_reward(p, c, VOCAB),
        prompts=actor.increment_prompts(SEQ, VOCAB, 7919), oracle_fn=_oracle, **settings)
    # push mode (no checkpoint directory): the policy arrives through
    # install_policy, as the remote plane will ship it
    push = actor.RolloutActor(
        trainer.model, None,
        reward_fn=lambda p, c: actor.increment_reward(p, c, VOCAB),
        prompts=actor.increment_prompts(SEQ, VOCAB, 7919), oracle_fn=_oracle, **settings)
    out = {"jax": [_pairs(jact.generate_pairs(4))], "port": [_pairs(pact.generate_pairs(4))],
           "push": [_pairs(push.generate_pairs(4))],
           "reload_before_commit": pact.maybe_reload(), "push_reload": push.maybe_reload()}

    base = {k: v.clone() for k, v in trainer.model.state_dict().items()
            if not k.endswith((".lora_a", ".lora_b"))}
    # the learner commits step 5 with the adapter; the JAX actor installs it
    trainer.model.load_state_dict(from_flax({**frozen, "lora": lora}, cfg))
    CheckpointManager(ckpt_dir).save(5, trainer.state_dict(), blocking=True)
    out["reloaded"] = pact.maybe_reload()
    out["reload_again"] = pact.maybe_reload()
    jact.install_policy(5, lora)
    adapter = {k: v for k, v in trainer.state_dict()["trainable"].items()}
    out["installed"] = (push.install_policy(5, adapter), push.install_policy(5, adapter),
                        push.install_policy(4, adapter))
    out["jax"].append(_pairs(jact.generate_pairs(4)))
    out["port"].append(_pairs(pact.generate_pairs(4)))
    out["push"].append(_pairs(push.generate_pairs(4)))
    out["base_after"] = {k: v for k, v in trainer.model.state_dict().items() if k in base}
    out.update(base=base, actor=pact, trainer=trainer)
    return out


def test_actor_pairs_equal_reference_before_and_after_reload(actors):
    assert actors["reload_before_commit"] is False
    assert actors["reloaded"] is True and actors["reload_again"] is False
    assert actors["actor"].version == 5 and actors["actor"].reloads == 1
    for got, want in zip(actors["port"], actors["jax"]):
        assert len(got) == 4 and got == want
    # greedy candidates tie: every pair is an oracle bootstrap
    assert actors["actor"].bootstrap_pairs == 8
    assert [p[3] for p in actors["port"][1]] == [5] * 4
    # the reload changed the policy's tokens
    assert [p[2] for p in actors["port"][0]] != [p[2] for p in actors["port"][1]]


def test_push_mode_installs_the_same_policy(actors):
    """``install_policy`` (push mode) gives the pairs a checkpoint reload
    gives; a repeated or older version is a no-op, and push mode never
    polls a checkpoint directory."""
    assert actors["push_reload"] is False
    assert actors["installed"] == (True, False, False)
    assert actors["push"] == actors["port"]


def test_reload_leaves_the_learners_base_unchanged(actors):
    base, after = actors["base"], actors["base_after"]
    assert set(base) == set(after) and base
    for k, v in base.items():
        assert torch.equal(after[k], v), k
    # the engine's merged kernels are storage of their own; the rest is shared
    engine = dict(actors["actor"].engine.model.state_dict())
    learner = dict(actors["trainer"].model.state_dict())
    merged = [k for k in engine if k.endswith(".kernel") and f"{k[:-7]}.lora_a" in learner]
    assert merged
    for k in engine:
        shared = engine[k].data_ptr() == learner[k].data_ptr()
        assert shared == (k not in merged), k


def _job(tmp_path, task: str) -> tuple[str, list[dict]]:
    art = tmp_path / task
    spec = {"job_id": task, "model": {"preset": "tiny-test", "lora": {"rank": 4},
                                      "overrides": {"dtype": "float32"}},
            "training": {"task": task, "total_steps": 4, "batch_size": 4, "seq_len": SEQ,
                         "log_every": 1, "checkpoint_every": 2, "grad_accum_steps": 2,
                         "eval_every": 2, "eval_steps": 1, "dpo_beta": 0.2,
                         "learning_rate": 5e-3, "warmup_steps": 1},
            "artifacts_dir": str(art)}
    if task == "rlhf":
        spec["rollout"] = {"pairs_per_round": 4, "min_fill": 4, "max_new_tokens": 4,
                           "slots": 2, "temperature": 0.9}
    path = tmp_path / f"{task}.json"
    path.write_text(json.dumps(spec))
    assert cli.main(["--spec", str(path), "--device", "cpu"]) == 0
    with open(art / "metrics.csv") as f:
        return str(art), list(csv.DictReader(f))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jobs")
    return {task: _job(tmp, task) for task in ("dpo", "reward", "rlhf")}


@pytest.mark.parametrize("task", ["dpo", "reward", "rlhf"])
def test_preference_job_through_the_cli(jobs, task):
    import os

    art, rows = jobs[task]
    assert [int(r["step"]) for r in rows] == [1, 2, 3, 4]
    accuracy = "bt_accuracy" if task == "reward" else "dpo_accuracy"
    for key in ("loss", "reward_margin", accuracy):
        assert all(np.isfinite(float(r[key])) for r in rows), key
    assert np.isfinite(float(rows[-1][f"eval_{accuracy}"]))
    assert CheckpointManager(f"{art}/checkpoints").steps() == [2, 4]
    assert os.path.exists(f"{art}/done.txt")
    assert os.path.exists(f"{art}/adapter/adapter_model.safetensors")
    if task == "rlhf":
        # each row trained on rollouts of the step committed one round before
        assert [int(float(r["actor_version"])) for r in rows] == [0, 0, 2, 2]
        assert all(float(r["rollout_buffer_depth"]) >= 4 for r in rows)
    if task == "reward":
        head = read_reward_head(art)
        assert {k: tuple(v.shape) for k, v in head.items()} == {
            "a": (), "w": (VOCAB,), "b": ()}
        state = CheckpointManager(f"{art}/checkpoints").restore(4)["trainable"]
        for k, v in head.items():
            assert torch.equal(state[f"head.{k}"], v)


@pytest.mark.parametrize("task", ["dpo", "reward", "rlhf"])
def test_loader_serves_the_preference_job(jobs, task):
    art, _ = jobs[task]
    model, meta = load_serving_model(art, merge_lora=False, device="cpu")
    assert meta["task"] == task and meta["checkpoint_step"] == 4
    assert not any(k.startswith("head") for k in model.state_dict())
    trainer = cli.trainer_class(task)(cli.build_model_config(json.load(open(
        f"{art}/resolved_config.json"))), cli.build_train_config(json.load(open(
            f"{art}/resolved_config.json"))), device="cpu")
    trainer.load_state(CheckpointManager(f"{art}/checkpoints").restore(4))
    tokens = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]])
    with torch.no_grad():
        assert torch.equal(model(tokens), trainer.model(tokens))
    merged, _ = load_serving_model(art, device="cpu")
    from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig

    engine = BatchEngine(merged, EngineConfig(slots=2, prompt_buckets=(8,), max_new_tokens=4,
                                              page_tokens=4))
    out = engine.run([GenRequest("a", [1, 2, 3], 4)])["a"]
    assert len(out.generated) == 4


def test_rollout_config_env_overrides(monkeypatch):
    monkeypatch.setenv("FTC_RLHF_PAIRS_PER_ROUND", "7")
    monkeypatch.setenv("FTC_RLHF_TEMPERATURE", "0.25")
    got = RolloutConfig(min_fill=3).apply_env_overrides()
    assert (got.pairs_per_round, got.temperature, got.min_fill) == (7, 0.25, 3)
