"""Built-in example job specs (reference: ``app/models/examples/mnist.py`` —
SURVEY.md §2 component 4's example half).

The reference ships one CPU-runnable example (MNIST with ``no_cuda``,
``mnist.py:28-30``) as its designed smoke workload; ours is a TinyLlama LoRA
SFT spec runnable on a CPU mesh (BASELINE config #1) plus the larger model
family specs from BASELINE.md.

Each module is also executable as a self-test by convention (reference:
``mnist.py:102-107``, ``docs/setup_models.md:419-430``):
``python -m finetune_controller_tpu_torch.controller.examples``.

In the port's copy every spec whose default device was a TPU slice
defaults to the ``h100`` card; the ``tiny-*`` specs run on ``cpu-test``.
The preference specs (DPO, RLHF and the reward model) train through the
port's ``prefs/`` trainers and promote and serve as LoRA jobs; an RLHF job
with ``rollout_workers > 0`` runs its actors in rollout worker processes on
the job's card (``prefs/rollout_plane.py``).  A spec whose mesh policy one card
cannot satisfy (the MoE specs' ``ep``, the long-context spec's ``sp``) is
refused with the reference's ``ValueError``.  ``mistral-7b-qlora`` (an
int4 base) runs, and so do ``llava-1.5-lora`` and ``tiny-mm-test-lora``
(multimodal: they train and promote; serving them is refused with the
reference's words, as the reference's loader refuses them).
"""

from __future__ import annotations

from pydantic import Field

from .specs import (
    BaseFineTuneJob,
    TrainingArguments,
    TrainingDataset,
    TrainingFramework,
    TrainingTask,
)


class LoRASFTArguments(TrainingArguments):
    """Hyperparameters surfaced on the submission form — the Field metadata IS
    the UI (reference pattern: ``mnist.py:17-38``)."""

    learning_rate: float = Field(
        2e-4, gt=0, le=1.0, description="Peak AdamW learning rate"
    )
    total_steps: int = Field(100, ge=1, le=1_000_000, description="Optimizer steps")
    warmup_steps: int = Field(10, ge=0, description="Linear warmup steps")
    batch_size: int = Field(8, ge=1, le=4096, description="Global batch size (rows)")
    seq_len: int = Field(512, ge=16, le=1_048_576, description="Sequence length")
    lora_rank: int = Field(16, ge=1, le=256, description="LoRA adapter rank")
    weight_decay: float = Field(0.0, ge=0, description="AdamW weight decay")
    seed: int = Field(0, description="PRNG seed")
    profile_steps: int = Field(
        0, ge=0, le=100,
        description="Capture a jax.profiler trace for N steps (0 = off); the "
                    "trace ships with the job artifacts under profile/",
    )
    eval_every: int = Field(
        0, ge=0,
        description="Evaluate a held-out split every N steps (0 = off); adds "
                    "eval_loss/eval_accuracy columns to the metrics",
    )
    eval_steps: int = Field(
        8, ge=1, le=1024, description="Batches averaged per evaluation pass"
    )
    grad_accum_steps: int = Field(
        1, ge=1, le=1024,
        description="Microbatches accumulated per optimizer step (batch_size "
                    "must divide by it) — for batches whose activations "
                    "exceed HBM",
    )
    log_every: int = Field(
        10, ge=1, description="Metrics-row cadence (optimizer steps)"
    )
    checkpoint_every: int = Field(
        100, ge=1,
        description="Checkpoint cadence (optimizer steps) — also the resume "
                    "granularity after preemption or a supervised retry",
    )


class DPOArguments(LoRASFTArguments):
    """Hyperparameters of a DPO job (docs/preference.md): the SFT knobs plus
    the preference-objective β."""

    beta: float = Field(
        0.1, gt=0, le=100,
        description="DPO inverse-temperature β — how strongly the implicit "
                    "KL pins the policy to the frozen reference (the "
                    "adapter-disabled base)",
    )


class RLHFArguments(DPOArguments):
    """DPO knobs plus the actor/learner rollout loop's
    (``prefs/learner.py::RolloutConfig``; ``FTC_RLHF_*`` env vars override
    per pod)."""

    rollout_pairs_per_round: int = Field(
        16, ge=1, le=4096,
        description="Prompts the actor decodes (2 candidates each) per "
                    "generation round",
    )
    rollout_buffer_capacity: int = Field(
        256, ge=1, le=1_000_000,
        description="Rollout buffer size (bounded; oldest pairs drop first)",
    )
    rollout_min_fill: int = Field(
        16, ge=1, le=1_000_000,
        description="Pairs the buffer must hold before the learner samples "
                    "a batch",
    )
    rollout_staleness_checkpoints: int = Field(
        2, ge=1, le=1000,
        description="Staleness cap: drop pairs generated more than this "
                    "many checkpoints behind the newest commit",
    )
    rollout_temperature: float = Field(
        0.8, ge=0, le=10,
        description="Actor sampling temperature (two candidates per prompt)",
    )
    rollout_top_k: int = Field(
        0, ge=0, le=100_000,
        description="Actor top-k sampling cutoff (0 = full distribution)",
    )
    rollout_max_new_tokens: int = Field(
        16, ge=1, le=4096, description="Completion length per rollout"
    )
    rollout_slots: int = Field(
        4, ge=1, le=256,
        description="Decode lanes of the actor's serve engine",
    )
    rollout_workers: int = Field(
        0, ge=0, le=64,
        description="Remote rollout actor processes (0 = the in-process "
                    "actor/learner gang; > 0 selects the disaggregated "
                    "data plane — docs/preference.md §Disaggregated "
                    "rollouts)",
    )
    rollout_reward_host: str = Field(
        "", description="Served reward model host the remote actors score "
                        "against (empty = programmatic increment reward)",
    )
    rollout_reward_port: int = Field(
        0, ge=0, le=65535,
        description="Served reward model port (0 = programmatic reward)",
    )


class RewardModelArguments(DPOArguments):
    """Hyperparameters of a ``task: reward`` job: the DPO data-path knobs
    train a Bradley–Terry scalar head on the policy trunk
    (``prefs/reward_trainer.py``); β is ignored by the objective."""


class TinyLlamaLoRA(BaseFineTuneJob):
    """BASELINE config #1 — the CPU-runnable smoke workload and CI workhorse."""

    model_name = "tinyllama-1.1b-lora"
    description = "TinyLlama-1.1B LoRA SFT (single host; CPU-runnable smoke config)"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "tinyllama-1.1b"
    default_device = "cpu-test"
    promotion_path = "models/tinyllama"

    training_arguments: LoRASFTArguments


class Llama3_8B_LoRA(BaseFineTuneJob):
    """BASELINE config #2 — the port's main path: full width and depth on
    one H100."""

    model_name = "llama3-8b-lora"
    description = "Llama-3 8B LoRA SFT on one H100"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "llama3-8b"
    default_device = "h100"
    promotion_path = "models/llama3-8b"

    training_arguments: LoRASFTArguments


class Llama32_3B_LoRA(BaseFineTuneJob):
    """Llama-3.2 small family (tied embeddings + llama3 RoPE scaling to
    128k positions) — rope-scaling numerics verified against transformers
    (tests/test_hf_import.py)."""

    model_name = "llama3.2-3b-lora"
    description = "Llama-3.2 3B LoRA SFT (llama3 RoPE scaling, 128k positions)"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "llama3.2-3b"
    default_device = "h100"
    promotion_path = "models/llama3.2-3b"

    training_arguments: LoRASFTArguments


class Gemma7B_LoRA(BaseFineTuneJob):
    """Gemma family (GeGLU, tied head, head_dim 256) — numerics verified
    against transformers' GemmaForCausalLM (tests/test_hf_import.py)."""

    model_name = "gemma-7b-lora"
    description = "Gemma-7B LoRA SFT on one H100"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "gemma-7b"
    default_device = "h100"
    promotion_path = "models/gemma-7b"

    training_arguments: LoRASFTArguments


class Qwen2_7B_LoRA(BaseFineTuneJob):
    """Qwen-2 family (q/k/v projection biases) — numerics verified against
    transformers' Qwen2ForCausalLM (tests/test_hf_import.py)."""

    model_name = "qwen2-7b-lora"
    description = "Qwen2-7B LoRA SFT on one H100"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "qwen2-7b"
    default_device = "h100"
    promotion_path = "models/qwen2-7b"

    training_arguments: LoRASFTArguments


class Mistral7B_LongContext_LoRA(BaseFineTuneJob):
    """Long-context SFT: the reference shards the sequence dimension over an
    ``sp`` ring (``parallel/ring.py``, not ported: ROADMAP Queue A item 7);
    the port renders a one-device mesh. The 32k preset raises the RoPE base to 1e6 (the Mistral v0.2+
    recipe) so positions past 8k stay in the trained frequency range.
    Ulysses head-sharding (``attention_impl="ulysses"``) is the alternative
    when sp divides the model's KV heads — see docs/performance.md."""

    model_name = "mistral-7b-longctx-lora"
    description = "Mistral-7B 32k-context LoRA SFT on one H100"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "mistral-7b-32k"
    default_device = "h100"
    promotion_path = "models/mistral-7b"
    mesh_policy = {"sp": 4, "fsdp": -1}

    training_arguments: LoRASFTArguments


class Mistral7B_QLoRA(BaseFineTuneJob):
    """BASELINE config #3 — int4-quantized base weights, LoRA deltas."""

    model_name = "mistral-7b-qlora"
    description = "Mistral-7B QLoRA (int4 base weights) on one H100"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_QLORA
    model_preset = "mistral-7b"
    default_device = "h100"
    promotion_path = "models/mistral-7b"

    training_arguments: LoRASFTArguments


class Mixtral8x7B_MoE_LoRA(BaseFineTuneJob):
    """BASELINE config #4 — MoE LoRA with expert parallelism.  The port
    trains MoE on one card, but one card cannot satisfy this spec's mesh
    policy ``{"ep": 8}``: ``controller/devices.py::default_mesh_for``
    refuses it with the reference's ``ValueError`` until multi-card meshes
    are ported (ROADMAP Queue A item 7).  A trainer spec with no mesh
    trains Mixtral-8x7B (with ``quantize_base`` its int4 experts fit).

    The mesh policy puts the 8 experts on the ``ep`` axis (expert matmuls stay
    chip-local, token exchange is an all-to-all over ICI) and FSDP-shards the
    rest of the slice.
    """

    model_name = "mixtral-8x7b-moe-lora"
    description = "Mixtral 8x7B MoE LoRA on one H100"
    task = TrainingTask.CAUSAL_LM
    framework = TrainingFramework.JAX_LORA
    model_preset = "mixtral-8x7b"
    default_device = "h100"
    promotion_path = "models/mixtral-8x7b"
    mesh_policy = {"ep": 8, "fsdp": -1}

    training_arguments: LoRASFTArguments


class TinyMoETestLoRA(BaseFineTuneJob):
    """Milliseconds-scale MoE spec — proves a submitted job trains with
    ``ep > 1`` on the virtual CPU mesh (the Mixtral path's e2e smoke)."""

    model_name = "tiny-moe-test-lora"
    description = "2-layer 4-expert test model; MoE e2e smoke spec"
    model_preset = "tiny-moe-test"
    default_device = "cpu-test"
    promotion_path = "models/tiny-moe-test"
    mesh_policy = {"ep": 2, "fsdp": -1}
    dataset = TrainingDataset(required=False, description="optional jsonl")

    training_arguments: LoRASFTArguments


class Llava15LoRA(BaseFineTuneJob):
    """BASELINE config #5 — LLaVA-1.5 multimodal SFT (ViT → projector →
    Llama decoder; the projector trains alongside the LoRA adapters)."""

    model_name = "llava-1.5-lora"
    description = "LLaVA-1.5 7B multimodal SFT (LoRA + projector) on one H100"
    task = TrainingTask.MULTIMODAL
    framework = TrainingFramework.JAX_LORA
    model_preset = "llava-1.5-7b"
    default_device = "h100"
    promotion_path = "models/llava-1.5"

    training_arguments: LoRASFTArguments


class TinyMMTestLoRA(BaseFineTuneJob):
    """Milliseconds-scale multimodal spec for the e2e lifecycle tests."""

    model_name = "tiny-mm-test-lora"
    description = "2-layer ViT + 2-layer decoder; multimodal e2e smoke spec"
    task = TrainingTask.MULTIMODAL
    model_preset = "tiny-mm-test"
    default_device = "cpu-test"
    promotion_path = "models/tiny-mm-test"
    dataset = TrainingDataset(required=False, description="optional jsonl")

    training_arguments: LoRASFTArguments


class TinyLlamaDPO(BaseFineTuneJob):
    """TinyLlama preference tuning — the CPU-runnable DPO config
    (docs/preference.md)."""

    model_name = "tinyllama-1.1b-dpo"
    description = "TinyLlama-1.1B DPO over preference pairs (LoRA policy, " \
                  "adapter-disabled reference)"
    task = TrainingTask.DPO
    framework = TrainingFramework.JAX_LORA
    model_preset = "tinyllama-1.1b"
    default_device = "cpu-test"
    promotion_path = "models/tinyllama"
    dataset = TrainingDataset(
        required=False,
        description="preference jsonl: {prompt, chosen, rejected} rows "
                    "(or *_tokens variants); omitted = seeded synthetic pairs",
    )

    training_arguments: DPOArguments


class Llama3_8B_DPO(BaseFineTuneJob):
    """Llama-3 8B DPO — the production-shaped
    preference-tuning config."""

    model_name = "llama3-8b-dpo"
    description = "Llama-3 8B DPO on one H100"
    task = TrainingTask.DPO
    framework = TrainingFramework.JAX_LORA
    model_preset = "llama3-8b"
    default_device = "h100"
    promotion_path = "models/llama3-8b"
    dataset = TrainingDataset(
        required=False,
        description="preference jsonl: {prompt, chosen, rejected} rows",
    )

    training_arguments: DPOArguments


class TinyDPOTest(BaseFineTuneJob):
    """Milliseconds-scale DPO spec for the e2e lifecycle tests."""

    model_name = "tiny-dpo-test"
    description = "2-layer test model; DPO e2e smoke spec"
    task = TrainingTask.DPO
    model_preset = "tiny-test"
    default_device = "cpu-test"
    promotion_path = "models/tiny-test"
    dataset = TrainingDataset(required=False, description="optional jsonl")

    training_arguments: DPOArguments


class TinyRLHFTest(BaseFineTuneJob):
    """RLHF-lite smoke spec: the actor (serve engine over the latest
    committed checkpoint) and the DPO learner run as an inseparable gang —
    ``atomic_gang`` makes the scheduler admit the 2 slices all-or-nothing
    and never shrink them (a partial gang cannot run)."""

    model_name = "tiny-rlhf-test"
    description = "2-layer test model; actor/learner RLHF-lite gang smoke spec"
    task = TrainingTask.RLHF
    model_preset = "tiny-test"
    default_device = "cpu-test"
    default_num_slices = 2  # learner slice + actor slice, admitted as a gang
    atomic_gang = True
    promotion_path = "models/tiny-test"
    dataset = TrainingDataset(required=False, description="optional jsonl")

    training_arguments: RLHFArguments


class TinyRewardTest(BaseFineTuneJob):
    """Reward-model smoke spec: Bradley–Terry head + LoRA trunk trained on
    the synthetic preference pairs; promotable and servable as the rlhf
    actors' scoring endpoint (``reward_score`` RPC)."""

    model_name = "tiny-reward-test"
    description = "2-layer test model; Bradley–Terry reward-model smoke spec"
    task = TrainingTask.REWARD
    model_preset = "tiny-test"
    default_device = "cpu-test"
    promotion_path = "models/tiny-test"
    dataset = TrainingDataset(
        required=False,
        description="preference jsonl: {prompt, chosen, rejected} rows "
                    "(omitted = seeded synthetic pairs)",
    )

    training_arguments: RewardModelArguments


class TinyTestLoRA(BaseFineTuneJob):
    """Milliseconds-scale spec used by the e2e lifecycle tests."""

    model_name = "tiny-test-lora"
    description = "2-layer test model; e2e lifecycle smoke spec"
    model_preset = "tiny-test"
    default_device = "cpu-test"
    promotion_path = "models/tiny-test"
    # smoke spec trains on synthetic data when no dataset is provided
    dataset = TrainingDataset(required=False, description="optional jsonl")

    training_arguments: LoRASFTArguments


BUILTIN_JOB_SPECS: list[type[BaseFineTuneJob]] = [
    TinyLlamaLoRA,
    Llama32_3B_LoRA,
    Llama3_8B_LoRA,
    Gemma7B_LoRA,
    Qwen2_7B_LoRA,
    Mistral7B_LongContext_LoRA,
    Mistral7B_QLoRA,
    Mixtral8x7B_MoE_LoRA,
    Llava15LoRA,
    TinyLlamaDPO,
    Llama3_8B_DPO,
    TinyTestLoRA,
    TinyMoETestLoRA,
    TinyMMTestLoRA,
    TinyDPOTest,
    TinyRLHFTest,
    TinyRewardTest,
]


if __name__ == "__main__":
    # executable smoke-validation, the model-author convention
    import typing as _typing

    for cls in BUILTIN_JOB_SPECS:
        args_cls = _typing.get_type_hints(cls)["training_arguments"]
        job = cls(training_arguments=args_cls())
        spec = job.build_trainer_spec("smoke-1", "/tmp/artifacts")
        assert spec["model"]["preset"] == cls.model_preset
        print(f"{cls.model_name}: ok ({spec['training']})")
