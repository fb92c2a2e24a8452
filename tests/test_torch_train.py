"""The port's training path against the JAX reference, on the same numpy
inputs.

* ``next_token_loss``: f32, 1e-6;
* the LR schedule: every step of the cosine, linear and constant schedules
  against optax, rtol 1e-6 (Python floats against optax's f32);
* the optimizer: three updates against ``optax.chain(clip_by_global_norm,
  adamw)`` with the norm above the clip and weight decay on, 1e-6;
* the trainer: the port's ``Trainer`` and the JAX ``Trainer`` on
  ``tiny-test`` in f32 take 5 steps on packed batches (``segment_ids``)
  from one noisy numpy tree (no adapter gradient is identically 0) — once
  with ``grad_accum_steps=2``, once with ``attention_impl="pallas"`` on both
  sides.
  The first step's gradients differ by f32 summation order only (~1e-5 of
  their largest element).  Adam divides each element's first moment by the
  root of its second: where the moment nearly cancels over steps, that
  noise becomes a visible share of the element's step (at most lr).  So:
  per-step loss to rtol 2e-5, grad_norm (of the drifted parameters) to
  rtol 1e-2, the trained LoRA leaves to atol 1e-3 = 0.1·lr (measured worst
  over six seeds: loss 3.6e-6, grad_norm 5.3e-3, leaves 2.3e-4);
* a QLoRA and an int4-expert MoE trainer: step-1 ``loss``, ``moe_aux`` and
  ``evaluate`` within rel 1e-5 of the JAX trainer's;
* the CLI's rejection messages equal the reference's;
* a run preempted by SIGTERM and resumed equals an uninterrupted one.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from finetune_controller_tpu.data.loader import batches_from_tokens, pack_documents
from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.train import cli as jax_cli
from finetune_controller_tpu.train.losses import next_token_loss as jax_loss
from finetune_controller_tpu.train.optimizer import build_optimizer, build_schedule as jax_sched
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu.train.trainer import Trainer as JaxTrainer
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.train import cli
from finetune_controller_tpu_torch.train.losses import next_token_loss
from finetune_controller_tpu_torch.train.optimizer import AdamW, build_schedule
from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)


def test_train_config_fields_match_reference():
    assert ([(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxTrainConfig)])


@pytest.mark.parametrize("masked", [False, True])
def test_next_token_loss_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 17), np.float32)
    tokens = rng.integers(0, 17, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    want_loss, want = jax_loss(jnp.asarray(logits), jnp.asarray(tokens),
                               None if mask is None else jnp.asarray(mask))
    got_loss, got = next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    for key in ("loss", "accuracy", "target_tokens"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_optax(schedule):
    for warmup, total in ((3, 20), (0, 7)):
        want = jax_sched(0.01, warmup, total, schedule)
        got = build_schedule(0.01, warmup, total, schedule)
        for step in range(total + 3):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                       err_msg=f"{schedule} step {step}")


def test_optimizer_update_matches_optax():
    """Three updates of clip_by_global_norm + adamw with weight decay, the
    gradient norm above the clip."""
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((3, 4), np.float32),
              "b": rng.standard_normal((5,), np.float32)}
    grads = [{k: 3.0 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx, _ = build_optimizer(learning_rate=0.05, warmup_steps=1, total_steps=10,
                            weight_decay=0.1, clip_norm=1.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    opt = AdamW(tparams, build_schedule(0.05, 1, 10), weight_decay=0.1, clip_norm=1.0)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        assert norm.item() > 1.0
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer
# ---------------------------------------------------------------------------

SEQ = 16


def _packed_batches(seed: int, batch_size: int, n: int):
    """n packed batches of documents of 3-20 tokens (segment ids, boundary
    targets masked), as the loader makes them."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, rng.integers(3, 21)).tolist() for _ in range(60)]
    tokens, segments, flags = pack_documents(docs, SEQ)
    it = batches_from_tokens(tokens, segments, batch_size, seed=seed, loss_flags=flags)
    return [next(it) for _ in range(n)]


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32), tree)


@pytest.mark.parametrize("case", ["accum2", "pallas"])
def test_trainer_matches_reference(case):
    accum, impl = (2, "xla") if case == "accum2" else (1, "pallas")
    train_kw = dict(mode="lora", learning_rate=0.01, warmup_steps=1, total_steps=5,
                    batch_size=4, seq_len=SEQ, grad_accum_steps=accum, prefetch=0)
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, attention_impl=impl,
                                            lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(**train_kw))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 5)
    trainable = _noisy(jax.device_get(state.trainable), 6)
    state = state.replace(frozen=frozen, trainable=trainable,
                          opt_state=jtrainer.tx.init(trainable))

    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, attention_impl=impl,
                                       lora=LoRAConfig(rank=4))
    trainer = Trainer(cfg, TrainConfig(**train_kw), device="cpu")
    trainer.model.load_state_dict(from_flax({**frozen, "lora": trainable}, cfg))

    for i, batch in enumerate(_packed_batches(7, 4, 5)):
        state, jm = jtrainer.step(state, dict(batch))
        tm = trainer.step(dict(batch))
        for key, rtol in (("loss", 2e-5), ("grad_norm", 1e-2), ("accuracy", 1e-6),
                          ("target_tokens", 0), ("learning_rate", 1e-6)):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    got = to_flax(trainer.model.state_dict(), cfg)["lora"]
    want = jax.device_get(state.trainable)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want) > 0
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, np.asarray(flat_want[path]), atol=1e-3, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", ["qlora", "moe"])
def test_int4_and_moe_trainers_match_reference(case):
    """A QLoRA ``tiny-test`` and an int4-expert ``tiny-moe-test`` (f32
    compute, the reference's own int4 draw, noisy float leaves): the first
    step's ``loss`` (the cross-entropy), ``moe_aux`` (the weighted
    load-balancing term the objective adds) and ``evaluate`` within rel 1e-5
    of the JAX trainer's."""
    preset = "tiny-test" if case == "qlora" else "tiny-moe-test"
    train_kw = dict(mode="lora", learning_rate=0.01, warmup_steps=1, total_steps=2,
                    batch_size=4, seq_len=SEQ, grad_accum_steps=2, eval_steps=2, prefetch=0)
    jcfg = JAX_PRESETS[preset].replace(dtype=jnp.float32, quantize_base=True,
                                       lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(**train_kw))
    state = jtrainer.init_state()
    rng = np.random.default_rng(5)
    frozen = jax.tree_util.tree_map(
        lambda x: (np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32)
                   if np.asarray(x).dtype == np.float32 else np.asarray(x)),
        jax.device_get(state.frozen))
    trainable = _noisy(jax.device_get(state.trainable), 6)
    state = state.replace(frozen=frozen, trainable=trainable,
                          opt_state=jtrainer.tx.init(trainable))
    cfg = PRESETS[preset].replace(dtype=torch.float32, quantize_base=True,
                                  lora=LoRAConfig(rank=4))
    trainer = Trainer(cfg, TrainConfig(**train_kw), device="cpu")
    trainer.model.load_state_dict(from_flax({**frozen, "lora": trainable}, cfg))
    batches = _packed_batches(8, 4, 3)
    want_eval = jtrainer.evaluate(state, iter([dict(b) for b in batches[1:]]))
    got_eval = trainer.evaluate(iter([dict(b) for b in batches[1:]]))
    _, jm = jtrainer.step(state, dict(batches[0]))
    tm = trainer.step(dict(batches[0]))
    keys = ["loss", "accuracy"] + (["moe_aux"] if case == "moe" else [])
    assert ("moe_aux" in tm) == (case == "moe")
    for key in keys:
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=1e-5, err_msg=key)
    for key in ("eval_loss", "eval_accuracy"):
        np.testing.assert_allclose(got_eval[key], want_eval[key], rtol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _message(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


@pytest.mark.parametrize("spec,which", [
    ({"model": {"preset": "nope"}}, "model"),
    ({"training": {"learning_rate": 1e-3, "bogus": 1, "also_bogus": 2}}, "train"),
])
def test_cli_rejections_match_reference(spec, which):
    fn = {"model": (cli.build_model_config, jax_cli.build_model_config),
          "train": (cli.build_train_config, jax_cli.build_train_config)}[which]
    assert _message(fn[0], spec) == _message(fn[1], spec)


def test_cli_rejects_unconsumed_arguments_and_unknown_task(tmp_path):
    spec = {"artifacts_dir": str(tmp_path / "a"), "extra_arguments": {"beta": 1}}
    assert _message(cli.run_job, spec, "cpu") == _message(jax_cli.run_job, spec)
    spec = {"artifacts_dir": str(tmp_path / "b"), "training": {"task": "nope"}}
    with pytest.raises(ValueError, match=r"unknown training task 'nope'; one of "
                                         r"\['sft', 'dpo', 'rlhf', 'reward'\]"):
        cli.run_job(spec, "cpu")


@pytest.mark.parametrize("spec,match", [
    # the preference trainers and the disaggregated rollout plane run
    # (tests/test_torch_prefs.py, tests/test_torch_rollout_plane.py); an rlhf
    # job with remote workers on a mesh one card cannot form is refused
    pytest.param({"training": {"task": "rlhf", "rollout_workers": 1}, "mesh": {"dp": 2}},
                 r"mesh axes \{'dp': 2\}.*multi-GPU", id="spec0-preference plane"),
    ({"mesh": {"dp": 2}}, "multi-GPU"),
    # multimodal trains on one card (tests/test_torch_multimodal.py); a
    # LLaVA spec with a mesh one card cannot form is refused
    pytest.param({"model": {"preset": "tiny-mm-test"}, "mesh": {"fsdp": 2}},
                 r"mesh axes \{'fsdp': 2\}.*multi-GPU", id="spec3-multimodal"),
    # MoE trains on one card; the Mixtral example's ``ep`` mesh is refused
    pytest.param({"model": {"preset": "tiny-moe-test"}, "mesh": {"ep": 2}},
                 r"mesh axes \{'ep': 2\}.*multi-GPU", id="spec4-MoE"),
])
def test_cli_refuses_what_the_slice_cannot_train(spec, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        cli.run_job({"artifacts_dir": str(tmp_path), **spec}, "cpu")


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_resume_after_preemption_equals_uninterrupted(tmp_path):
    """SIGTERM after step 3 checkpoints and exits 143; a new process (a new
    Trainer) resumes from step 3 and ends where an uninterrupted run ends."""
    spec = {"model": {"preset": "tiny-test", "lora": {"rank": 4},
                      "overrides": {"dtype": "float32"}},
            "training": {"total_steps": 6, "batch_size": 4, "seq_len": SEQ, "log_every": 1,
                         "checkpoint_every": 100, "warmup_steps": 2, "learning_rate": 0.01},
            "dataset": {"synthetic": {"task": "increment"}}}

    def trainer(run_dir):
        s = {**spec, "artifacts_dir": str(run_dir)}
        cfg, tcfg = cli.build_model_config(s), cli.build_train_config(s)
        return Trainer(cfg, tcfg, device="cpu"), cli.build_batches(s, cfg, tcfg)

    full, batches = trainer(tmp_path / "full")
    full.fit(batches, str(tmp_path / "full"))

    def preempt_at_3(step, _metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    t1, batches = trainer(tmp_path / "cut")
    with pytest.raises(SystemExit) as info:
        t1.fit(batches, str(tmp_path / "cut"), on_metrics=preempt_at_3)
    assert info.value.code == 143
    assert os.path.isdir(tmp_path / "cut" / "checkpoints" / "step_3")
    t2, batches = trainer(tmp_path / "cut")
    t2.fit(batches, str(tmp_path / "cut"))
    for name, p in full.trainable.items():
        torch.testing.assert_close(t2.trainable[name], p, atol=0, rtol=0)
    want, got = _rows(tmp_path / "full" / "metrics.csv"), _rows(tmp_path / "cut" / "metrics.csv")
    assert [r["step"] for r in got] == [str(i) for i in range(1, 7)]
    assert [r["loss"] for r in got] == [r["loss"] for r in want]


def test_cli_end_to_end_on_cpu(tmp_path):
    """The spec CLI: resolved config, metrics rows, checkpoints, done.txt,
    and a second run with more steps resumes."""
    spec = {"job_id": "t", "model": {"preset": "tiny-test", "lora": {"rank": 4}},
            "training": {"total_steps": 4, "batch_size": 4, "seq_len": SEQ, "log_every": 2,
                         "checkpoint_every": 2, "grad_accum_steps": 2, "prefetch": 1},
            "dataset": {"synthetic": {"task": "increment"}},
            "artifacts_dir": str(tmp_path / "art")}
    path = tmp_path / "job.json"
    path.write_text(json.dumps(spec))
    assert cli.main(["--spec", str(path), "--device", "cpu"]) == 0
    art = tmp_path / "art"
    assert (art / "done.txt").exists() and (art / "resolved_config.json").exists()
    assert sorted(os.listdir(art / "checkpoints")) == ["step_2", "step_4"]
    spec["training"]["total_steps"] = 6
    path.write_text(json.dumps(spec))
    assert cli.main(["--spec", str(path), "--device", "cpu"]) == 0
    rows = _rows(art / "metrics.csv")
    assert [r["step"] for r in rows] == ["2", "4", "6"]
    assert all(np.isfinite(float(r["loss"])) and float(r["grad_norm"]) > 0 for r in rows)
