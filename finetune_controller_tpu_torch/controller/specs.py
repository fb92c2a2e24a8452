"""Declarative fine-tune job specs — the model-author contract.

The port's copy renders the spec that ``python -m
finetune_controller_tpu_torch.train.cli`` reads (the same schema as the
reference's trainer CLI); the framework names (``jax_lora`` …) stay the
reference's, since they are values of the public API.

Capability parity with the reference's ``BaseFineTuneModel``
(``app/models/base/finetuning.py:51-145`` — SURVEY.md §2 component 4), redesigned
for the TPU stack:

- the reference's ``image`` + ``command`` + ``accelerator_count`` + ``cluster_nodes``
  (a user CUDA container on N GPU nodes) becomes ``device`` (a TPU slice flavor
  from the device catalog, e.g. ``v5e-16``) + ``num_slices`` + a **trainer spec**
  for our in-repo JAX trainer;
- typed ``TrainingArguments`` with pydantic ``Field`` metadata still double as the
  auto-generated submission form (reference: ``app/main.py:263-275`` serves the
  JSON schema — the ``description``/defaults/constraints ARE the UI);
- the ``__init_subclass__`` type-enforcement hook (reference:
  ``finetuning.py:110-145``) is kept: a subclass that overrides a field with the
  wrong type fails at class-definition time, not at submit time;
- ``run_cmd()`` (reference: ``finetuning.py:98-104``, ``mnist.py:75-99``) renders
  the container command for K8s-style backends; :meth:`build_trainer_spec`
  renders the in-process spec for the local backend.
"""

from __future__ import annotations

import enum
import shlex
import typing
from typing import Any, ClassVar

from pydantic import BaseModel, Field


class TrainingTask(str, enum.Enum):
    """Reference: ``TrainingTask`` enum, ``finetuning.py:8-12``; extended
    with the preference-optimization workloads (docs/preference.md)."""

    CAUSAL_LM = "causal_lm"
    CLASSIFICATION = "classification"
    MULTIMODAL = "multimodal"
    #: Direct Preference Optimization over (chosen, rejected) pairs
    DPO = "dpo"
    #: RLHF-lite: actor/learner gang — the serve engine generates on-policy
    #: rollouts that feed the DPO learner.  ``rollout_workers > 0``
    #: disaggregates the actors into remote worker processes
    #: (docs/preference.md §Disaggregated rollouts)
    RLHF = "rlhf"
    #: Bradley–Terry reward model: a scalar head on the DPO data path,
    #: servable on the fleet as the rlhf actors' scoring endpoint
    REWARD = "reward"


def known_tasks() -> list[str]:
    """Task values accepted at submit — the 400 on an unknown ``task`` names
    these (``controller/server.py``)."""
    return sorted(t.value for t in TrainingTask)


class TrainingFramework(str, enum.Enum):
    """Reference: ``TrainingFramework``, ``finetuning.py:14-16``; here the
    frameworks are JAX-stack modes rather than torch flavors."""

    JAX_LORA = "jax_lora"
    JAX_FULL = "jax_full"
    JAX_QLORA = "jax_qlora"


class TrainingArguments(BaseModel):
    """Base for user-facing typed hyperparameters (reference:
    ``finetuning.py:19-26``). Subclass and add pydantic fields; the JSON schema
    is served to the frontend as the submission form."""

    model_config = {"extra": "forbid"}


class TrainingResources(BaseModel):
    """Host-side resource requests for the job pods (reference:
    ``TrainingResources``, ``finetuning.py:28-35``). TPU chips come from the
    device flavor, not from here."""

    cpu: str = "4"
    memory: str = "16Gi"


class TrainingDataset(BaseModel):
    """Reference: ``TrainingDataset``, ``finetuning.py:37-44``."""

    required: bool = True
    description: str = "Training dataset (jsonl)"
    content_types: list[str] = Field(
        default_factory=lambda: ["application/jsonl", "text/csv", "application/json"]
    )


class BaseFineTuneJob(BaseModel):
    """Declarative job spec. Subclass per model family; register via
    :mod:`finetune_controller_tpu_torch.controller.registry`.

    Class-level declaration + instance-level user arguments, mirroring the
    reference's split (``finetuning.py:51-104``).
    """

    # ---- class-level contract (override in subclasses) ----
    model_name: ClassVar[str] = "base"
    description: ClassVar[str] = ""
    task: ClassVar[TrainingTask] = TrainingTask.CAUSAL_LM
    framework: ClassVar[TrainingFramework] = TrainingFramework.JAX_LORA
    #: model preset key in ``models.llama.PRESETS`` (or family-specific registry)
    model_preset: ClassVar[str] = "tiny-test"
    #: default flavor name from the device catalog; user may override at submit
    default_device: ClassVar[str] = "cpu-test"
    default_num_slices: ClassVar[int] = 1
    resources: ClassVar[TrainingResources] = TrainingResources()
    dataset: ClassVar[TrainingDataset] = TrainingDataset()
    #: artifact path where trained checkpoints land inside the job sandbox
    #: (reference: checkpoint_mount /data/artifacts, ``finetuning.py:70-73``)
    checkpoint_mount: ClassVar[str] = "/data/artifacts"
    #: glob patterns the artifact sync ships to the object store
    #: (reference: store_asset_patterns, ``finetuning.py:94-97``)
    store_asset_patterns: ClassVar[list[str]] = [
        "*.csv", "*.json", "checkpoints/**/*", "profile/**/*",
        "adapter/**/*", "merged/**/*", "done.txt",
        # observability (docs/observability.md): the trainer's lifecycle
        # events + spans ride the artifact channel like heartbeat.json
        "events.jsonl", "trace/**/*",
    ]
    #: deploy-bucket prefix used on promotion (reference: ``finetuning.py:75-78``)
    promotion_path: ClassVar[str] = "models"
    #: intra-slice mesh-axis declaration (fsdp/ep/pp/sp/tp; one axis may be -1
    #: = "all remaining chips"); resolved against the device flavor at submit
    #: by :func:`finetune_controller_tpu_torch.controller.devices.default_mesh_for`.
    #: MoE families set ``{"ep": N, "fsdp": -1}``, long-context ones add sp.
    mesh_policy: ClassVar[dict[str, int]] = {"fsdp": -1}
    #: HF checkpoint directory with the pretrained base weights (staged into
    #: the pod like a dataset); empty = random init (smoke/test specs)
    pretrained_weights_dir: ClassVar[str] = ""
    #: the job's slices form an inseparable GANG (actor+learner — the RLHF
    #: specs): the scheduler admits all-or-nothing as usual but additionally
    #: NEVER shrinks it — a partial gang cannot run, so elastic admission
    #: and resize-instead-of-evict fall back to full preemption for it
    #: (docs/preference.md, docs/elasticity.md)
    atomic_gang: ClassVar[bool] = False
    #: model-config overrides baked into the spec (``LlamaConfig`` field →
    #: value) — how a family spec pins its measured kernel winners
    #: (``flash_block_q``/``flash_block_k``/``flash_exp_dtype``/
    #: ``ring_inner``/``ulysses_inner``) so API-submitted jobs carry them;
    #: FTC_* env vars remain per-pod operator overrides
    model_overrides: ClassVar[dict] = {}

    # ---- instance-level (validated user input) ----
    training_arguments: TrainingArguments

    # -- subclass type enforcement (reference: finetuning.py:110-145) --------

    _CHECKED_CLASSVARS: ClassVar[dict[str, type]] = {
        "model_name": str,
        "description": str,
        "task": TrainingTask,
        "framework": TrainingFramework,
        "model_preset": str,
        "default_device": str,
        "default_num_slices": int,
        "resources": TrainingResources,
        "dataset": TrainingDataset,
        "checkpoint_mount": str,
        "store_asset_patterns": list,
        "promotion_path": str,
        "mesh_policy": dict,
        "pretrained_weights_dir": str,
        "model_overrides": dict,
        "atomic_gang": bool,
    }

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        for name, expected in cls._CHECKED_CLASSVARS.items():
            if name in cls.__dict__ and not isinstance(cls.__dict__[name], expected):
                raise TypeError(
                    f"{cls.__name__}.{name} must be {expected.__name__}, "
                    f"got {type(cls.__dict__[name]).__name__}"
                )
        hints = typing.get_type_hints(cls)
        ta = hints.get("training_arguments")
        if ta is not None and isinstance(ta, type) and not issubclass(ta, TrainingArguments):
            raise TypeError(
                f"{cls.__name__}.training_arguments must subclass TrainingArguments"
            )

    # -- rendering -----------------------------------------------------------

    @classmethod
    def arguments_schema(cls) -> dict[str, Any]:
        """JSON schema for the submission form (reference: ``main.py:263-275``)."""
        ta = typing.get_type_hints(cls)["training_arguments"]
        return ta.model_json_schema()

    def build_trainer_spec(
        self,
        job_id: str,
        artifacts_dir: str,
        *,
        dataset_path: str | None = None,
        mesh: dict[str, int] | None = None,
    ) -> dict[str, Any]:
        """Render the in-repo trainer's job spec (``train/cli.py`` schema).

        The TPU-native replacement for the reference's free-form container
        ``command`` — the training program is ours, so the spec is structured
        data, not a shell string.
        """
        args = self.training_arguments.model_dump()
        training = {
            "mode": "lora" if self.framework != TrainingFramework.JAX_FULL else "full",
        }
        preference = self.task in (
            TrainingTask.DPO, TrainingTask.RLHF, TrainingTask.REWARD,
        )
        if preference:
            # select the DPO/rlhf/reward trainer (prefs/, docs/preference.md)
            training["task"] = self.task.value
        # Lift known trainer knobs out of the user arguments.
        for key in (
            "learning_rate", "warmup_steps", "total_steps", "schedule",
            "weight_decay", "clip_norm", "batch_size", "seq_len", "seed",
            "log_every", "checkpoint_every", "profile_steps", "export_merged",
            "eval_every", "eval_steps", "frozen_dtype", "grad_accum_steps",
        ):
            if key in args:
                training[key] = args.pop(key)
        if "beta" in args:
            if preference:
                training["dpo_beta"] = args.pop("beta")
            else:
                args.pop("beta")  # meaningless for SFT; don't fail the run
        rollout: dict[str, Any] = {}
        if self.task is TrainingTask.RLHF:
            # remote actor count is a TRAINER knob (TrainConfig — it selects
            # the disaggregated data plane), not a RolloutConfig field
            if "rollout_workers" in args:
                training["rollout_workers"] = args.pop("rollout_workers")
            # actor/learner loop knobs (prefs/learner.py::RolloutConfig)
            for key in (
                "rollout_pairs_per_round", "rollout_buffer_capacity",
                "rollout_min_fill", "rollout_staleness_checkpoints",
                "rollout_temperature", "rollout_top_k",
                "rollout_max_new_tokens", "rollout_slots",
                "rollout_reward_host", "rollout_reward_port",
            ):
                if key in args:
                    rollout[key[len("rollout_"):]] = args.pop(key)
        model: dict[str, Any] = {"preset": self.model_preset}
        if self.pretrained_weights_dir:
            model["weights_dir"] = self.pretrained_weights_dir
        overrides = dict(self.model_overrides)
        if self.framework == TrainingFramework.JAX_QLORA:
            # int4 base weights (models/quant.py); adapters still train in LoRA
            overrides["quantize_base"] = True
        if overrides:
            model["overrides"] = overrides
        if "lora_rank" in args:
            model["lora"] = {"rank": args.pop("lora_rank")}
        spec: dict[str, Any] = {
            "job_id": job_id,
            "model": model,
            "training": training,
            "artifacts_dir": artifacts_dir,
        }
        if rollout:
            spec["rollout"] = rollout
        if mesh:
            spec["mesh"] = mesh
        if dataset_path:
            spec["dataset"] = {"path": dataset_path}
        elif preference:
            # DPO trains on the seeded synthetic increment pairs; the rlhf
            # actor generates its own data, so the dataset section only
            # drives the held-out eval stream (data/preference.py)
            spec["dataset"] = {"synthetic": {"task": "preference"}}
        else:
            # multimodal smoke jobs get the vision-wiring probe task; text
            # jobs the increment task (data/synthetic.py)
            task_name = (
                "brightness" if self.task is TrainingTask.MULTIMODAL else "increment"
            )
            spec["dataset"] = {"synthetic": {"task": task_name}}
        if args:
            spec["extra_arguments"] = args
        return spec

    def run_cmd(self, spec_path: str = "/data/job.json", *, device: str | None = None) -> str:
        """Container command for K8s-style backends (reference:
        ``finetuning.py:98-104``; done.txt convention
        ``PyTorchJobDeployer.py:30-32``).  ``device`` is the trainer CLI's
        ``--device`` (``cpu`` for a cpu flavor; none: the card)."""
        device_arg = f" --device {shlex.quote(device)}" if device else ""
        return (
            f"python -m finetune_controller_tpu_torch.train.cli --spec {shlex.quote(spec_path)}"
            f"{device_arg} && touch {shlex.quote(self.checkpoint_mount)}/done.txt"
        )
