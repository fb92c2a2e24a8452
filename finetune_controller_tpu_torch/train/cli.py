"""Training entrypoint of the port:
``python -m finetune_controller_tpu_torch.train.cli --spec job.json [--device cpu]``.

The same JSON spec as the reference's ``train/cli.py`` (the contract between
the control plane and the compute plane):

    {
      "job_id": "...",
      "model":    {"preset": "tiny-test", "overrides": {...}, "lora": {"rank": 8}},
      "training": {... TrainConfig fields ...},
      "mesh":     {"dp": 1, "fsdp": -1, "tp": 1, "sp": 1, "ep": 1, "pp": 1},
      "dataset":  {"path": "...", "tokenizer_file": null, "image_normalize": "clip"}
                  | {"synthetic": {"task": "increment"}},
      "artifacts_dir": "/data/artifacts"
    }

``model.weights_dir`` names a local HF checkpoint directory the base starts
from; ``dataset.eval_path`` is the held-out split ``training.eval_every``
evaluates on (a synthetic dataset holds out a disjoint stream by itself).
It writes ``resolved_config.json`` first, then what ``Trainer.fit`` writes
(``metrics.csv``, ``checkpoints/``, ``heartbeat.json``, ``events.jsonl``,
``trace/trainer.jsonl``), the HF exports (``adapter/`` for a LoRA run,
``merged/`` with ``training.export_merged``) and ``done.txt`` at the end.
A multimodal preset (``models/multimodal.MM_PRESETS``) reads image-bearing
rows through ``data/mm_loader.py`` (pixels resized to its tower and
normalized per ``dataset.image_normalize``), and its synthetic default is
the ``brightness`` task.  ``training.task`` picks the trainer
(:func:`trainer_class`): ``dpo`` and ``rlhf`` the DPO trainer, ``reward``
the reward model, each on preference-pair batches (``data/preference.py``);
``rlhf`` draws them from the in-process actor/learner loop configured by the
spec's ``rollout`` section (``prefs/learner.py``), or with
``training.rollout_workers > 0`` from that many rollout worker processes
(``prefs/rollout_plane.py``), which score with a served reward model when
``rollout.reward_port`` names one and are reaped when the job ends.  The run
is on the CUDA card unless ``--device`` names another (the rollout workers
run on the same device).  One device only: a mesh axis above 1 raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

import torch

logger = logging.getLogger(__name__)

_DTYPE_FIELDS = ("dtype", "param_dtype", "logits_dtype")


@dataclasses.dataclass
class MeshSpec:
    """The spec's mesh section (the reference's ``parallel/mesh.py``
    fields); the port runs on one device."""

    dp: int = 1
    fsdp: int = -1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1


def build_model_config(spec: dict):
    from ..models.llama import PRESETS
    from ..models.lora import LoRAConfig
    from ..models.multimodal import MM_PRESETS

    model_spec = spec.get("model", {})
    preset = model_spec.get("preset", "tiny-test")
    if preset in PRESETS:
        cfg = PRESETS[preset]
    elif preset in MM_PRESETS:
        cfg = MM_PRESETS[preset]
    else:
        raise ValueError(
            f"unknown model preset {preset!r}; have "
            f"{sorted(PRESETS) + sorted(MM_PRESETS)}"
        )
    overrides = dict(model_spec.get("overrides", {}))
    for name in _DTYPE_FIELDS:  # the spec names dtypes as strings
        if isinstance(overrides.get(name), str):
            overrides[name] = getattr(torch, overrides[name])
    if overrides:
        cfg = cfg.replace(**overrides)
    lora_spec = model_spec.get("lora")
    if lora_spec is not None:
        cfg = cfg.replace(lora=LoRAConfig(**lora_spec))
    return cfg


def build_train_config(spec: dict):
    from .trainer import TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    raw = dict(spec.get("training", {}))
    unknown = set(raw) - fields
    if unknown:
        raise ValueError(f"unknown training fields: {sorted(unknown)}")
    return TrainConfig(**raw)


def check_mesh(spec: dict) -> None:
    mesh = MeshSpec(**spec.get("mesh", {}))
    wide = {k: v for k, v in dataclasses.asdict(mesh).items() if v not in (1, -1)}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: the port trains on one device; meshes are not ported yet "
            "(ROADMAP Queue A item 7, multi-GPU)")


def build_batches(spec: dict, model_cfg, train_cfg, split: str = "train"):
    """The job's batch stream: ``dataset.path`` (``dataset.eval_path`` for
    ``split="eval"``) or the synthetic task; preference pairs for the
    ``dpo``, ``rlhf`` and ``reward`` tasks.  ``None`` for an eval split of a
    file dataset that names no ``eval_path``."""
    from ..data.loader import jsonl_token_batches
    from ..data.synthetic import synthetic_batches

    ds = spec.get("dataset", {})
    path = ds.get("eval_path") if split == "eval" else ds.get("path")
    if train_cfg.task in ("dpo", "rlhf", "reward"):
        from ..data.preference import preference_jsonl_batches, synthetic_preference_batches

        if path:
            return preference_jsonl_batches(path, batch_size=train_cfg.batch_size,
                                            seq_len=train_cfg.seq_len,
                                            tokenizer_file=ds.get("tokenizer_file"),
                                            seed=train_cfg.seed)
        if split == "eval" and ds.get("path"):
            # real preference data but no eval split configured
            return None
        # eval holds out a disjoint seed region, like the SFT synthetic path
        return synthetic_preference_batches(
            batch_size=train_cfg.batch_size, seq_len=train_cfg.seq_len,
            vocab_size=model_cfg.vocab_size,
            seed=train_cfg.seed + (100_003 if split == "eval" else 0))
    if path and model_cfg.image_size:
        # image-bearing rows: one sample per row, pixels resized to the
        # model's vision tower
        from ..data.mm_loader import mm_jsonl_batches

        return mm_jsonl_batches(path, batch_size=train_cfg.batch_size,
                                seq_len=train_cfg.seq_len, image_size=model_cfg.image_size,
                                tokenizer_file=ds.get("tokenizer_file"), seed=train_cfg.seed,
                                normalize=ds.get("image_normalize", "clip"))
    if path:
        return jsonl_token_batches(path, batch_size=train_cfg.batch_size,
                                   seq_len=train_cfg.seq_len,
                                   tokenizer_file=ds.get("tokenizer_file"),
                                   seed=train_cfg.seed)
    if split == "eval" and ds.get("path"):
        # real train data but no eval split configured: nothing held out
        return None
    synth = ds.get("synthetic", {})
    # the eval stream draws from a disjoint region of the generator's seed
    # space so held-out rows never coincide with training rows
    seed = train_cfg.seed + (100_003 if split == "eval" else 0)
    # multimodal configs get pixels sized to their vision tower
    image_size = model_cfg.image_size
    return synthetic_batches(batch_size=train_cfg.batch_size, seq_len=train_cfg.seq_len,
                             vocab_size=model_cfg.vocab_size,
                             task=synth.get("task", "brightness" if image_size else "increment"),
                             seed=seed, image_size=image_size)


def trainer_class(task: str):
    """The trainer class of ``training.task`` (the reference's dispatch in
    ``run_job`` and the serving loader)."""
    if task == "sft":
        from .trainer import Trainer

        return Trainer
    if task in ("dpo", "rlhf"):
        from ..prefs.dpo_trainer import DPOTrainer

        return DPOTrainer
    if task == "reward":
        from ..prefs.reward_trainer import RewardModelTrainer

        return RewardModelTrainer
    raise ValueError(
        f"unknown training task {task!r}; one of ['sft', 'dpo', 'rlhf', 'reward']"
    )


def run_job(spec: dict, device=None) -> None:
    extra = spec.get("extra_arguments")
    if extra:
        raise ValueError(
            f"unconsumed extra_arguments {sorted(extra)}: the job spec must map "
            "every user argument into the trainer spec (override "
            "build_trainer_spec in the spec class)"
        )
    artifacts_dir = spec["artifacts_dir"]
    os.makedirs(artifacts_dir, exist_ok=True)

    model_cfg = build_model_config(spec)
    train_cfg = build_train_config(spec)
    check_mesh(spec)
    with open(os.path.join(artifacts_dir, "resolved_config.json"), "w") as f:
        json.dump(spec, f, indent=2, default=str)
    trainer = trainer_class(train_cfg.task)(model_cfg, train_cfg, device=device)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logger.info("job %s: %s params=%.1fM device=%s", spec.get("job_id", "?"),
                spec.get("model", {}).get("preset"), n_params / 1e6, trainer.device)
    eval_batches = None
    if train_cfg.eval_every > 0:
        eval_batches = build_batches(spec, model_cfg, train_cfg, split="eval")
        if eval_batches is None:
            raise ValueError(
                "training.eval_every > 0 but the dataset has no eval split: "
                "set dataset.eval_path (or use a synthetic dataset, which "
                "holds out a disjoint stream automatically)"
            )
    weights_dir = spec.get("model", {}).get("weights_dir")
    plane = None
    if train_cfg.task == "rlhf":
        from ..prefs.learner import RolloutConfig, build_rlhf_loop

        rollout = RolloutConfig(**spec.get("rollout", {}))
        if train_cfg.rollout_workers > 0:
            # the disaggregated data plane: rollout worker processes stream
            # pairs in over the rollout RPCs; the base they decode with is
            # the learner's, pretrained weights loaded here once
            from ..prefs.rollout_plane import build_remote_rlhf_loop

            batches, plane, _buffer = build_remote_rlhf_loop(
                trainer, artifacts_dir, rollout=rollout, pretrained_dir=weights_dir,
                model_spec=spec.get("model", {}))
            weights_dir = None
        else:
            batches, _actor, _buffer = build_rlhf_loop(trainer, artifacts_dir, rollout=rollout)
    else:
        batches = build_batches(spec, model_cfg, train_cfg)
    try:
        trainer.fit(batches, artifacts_dir, pretrained_dir=weights_dir,
                    eval_batches=eval_batches)
        # deployable artifacts: the PEFT adapter (+ the merged checkpoint)
        trainer.export_artifacts(artifacts_dir)
    finally:
        if plane is not None:
            # the rollout workers are child processes: reap them even when
            # fit raises
            plane.close()
    with open(os.path.join(artifacts_dir, "done.txt"), "w") as f:
        f.write("done\n")
    logger.info("job %s finished", spec.get("job_id", "?"))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="ftc-train-torch")
    parser.add_argument("--spec", required=True, help="path to the job-spec JSON")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the first CUDA card)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stdout,
        force=True,
    )
    with open(args.spec) as f:
        spec = json.load(f)
    run_job(spec, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
