"""Load a trained job's checkpoint into a serving model (the local-directory
half of the reference's ``serve/loader.py``).

A job's artifacts directory — what ``python -m
finetune_controller_tpu_torch.train.cli`` writes, and what a promotion
copies — holds ``resolved_config.json`` (the job spec) and
``checkpoints/step_N/state.pt`` (the trainable tensors and the optimizer
state, ``train/checkpoint.py``).  This module turns that directory back
into a model the serving engine decodes with:

* :func:`load_serving_model` rebuilds the model as the trainer did (same
  preset, same seed, so the same frozen base for a from-scratch job; the
  HF checkpoint of ``model.weights_dir``, loaded in place, for a job that
  started from one), restores the latest checkpoint's trainable tensors
  into it, and — for a LoRA job — optionally folds the adapters into the
  base kernels
  (:func:`merge_lora_variables`: in f32, then cast to the serving dtype).
  The base is built in the spec's ``frozen_dtype``, or in the compute dtype
  when the spec names none, and served in the compute dtype: no f32 copy
  of a bf16-served base is made on the way.  An int4 base (QLoRA) is
  rebuilt by the same ``Trainer`` code from the same seed, so it is the
  base the job trained on, and it is served with its adapters unmerged
  (``lora_merged: false``), its packed kernels and scales as stored;
* :func:`strip_lora_for_multitenant` splits an unmerged model into the
  pristine base and the job's own adapter, which becomes a tenant;
* :func:`_load_adapter_tree` reads only a LoRA job's adapter (the
  checkpoint's trainable tensors), never the base; :func:`stage_meta` reads
  only the spec and the checkpoint listing.

The store-facing half serves a promoted job: :func:`resolve_promoted` (only
a COMPLETED promotion is servable), :func:`fetch_promoted` (stage the
spec and checkpoints of the deploy prefix), :func:`load_promoted` (resolve
→ stage → load, on the caller's device), :func:`load_adapter` (a tenant's
deltas only) and :func:`stage_for_workers` (resolve → stage → meta, no
weights).

Every entry point refuses what cannot be served with the reference's
messages (:class:`ServeLoadError`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any

import torch

from ..models.convert import merge_kernel, merged_config
from ..models.llama import LlamaForCausalLM, rope_inv_freqs
from ..models.multimodal import LlavaForCausalLM
from ..train.checkpoint import CheckpointManager
from ..train.cli import build_model_config, build_train_config

logger = logging.getLogger(__name__)

_LORA_LEAVES = (".lora_a", ".lora_b")
_INT4_LEAVES = ("_packed", "_scales")


class ServeLoadError(RuntimeError):
    """A job cannot be served; ``status`` maps to the HTTP response."""

    def __init__(self, message: str, status: int = 409):
        super().__init__(message)
        self.status = status


def _read_spec(local_dir: Path) -> dict:
    spec_path = local_dir / "resolved_config.json"
    if not spec_path.exists():
        raise ServeLoadError(
            f"{spec_path} missing: the promoted prefix carries no job spec"
        )
    with open(spec_path) as f:
        return json.load(f)


def _latest_step(local_dir: Path) -> int:
    ckpt_dir = local_dir / "checkpoints"
    if not ckpt_dir.is_dir() or not os.listdir(ckpt_dir):
        raise ServeLoadError(
            f"no checkpoints under {ckpt_dir} — the job produced none"
        )
    latest = CheckpointManager(ckpt_dir, sweep=False).latest_step()
    if latest is None:
        raise ServeLoadError(f"no committed checkpoint steps under {ckpt_dir}")
    return latest


def _model_config(spec: dict, multimodal_message: str):
    """The job's model config; a multimodal one is refused with
    ``multimodal_message`` (the reference serves text-only models)."""
    model_cfg = build_model_config(spec)
    if getattr(model_cfg, "vision", None) is not None:
        raise ServeLoadError(multimodal_message)
    return model_cfg


def _resolve_staged_spec(local_dir: Path) -> tuple[dict, Any, int]:
    """Shared validation for a staged job directory: spec read,
    serving-eligibility guards, latest committed checkpoint step.  Both
    :func:`load_serving_model` and :func:`stage_meta` run it, so a
    checkpoint is servable (or refused, with the same error) either way."""
    spec = _read_spec(local_dir)
    model_cfg = _model_config(spec, "serving multimodal checkpoints is not supported yet")
    if getattr(model_cfg, "n_experts", 0):
        raise ServeLoadError(
            "serving MoE checkpoints is not supported (batching invariance "
            "does not hold under capacity routing)"
        )
    return spec, model_cfg, _latest_step(local_dir)


def merge_lora_variables(model_cfg: Any, state: dict[str, torch.Tensor]
                         ) -> tuple[Any, dict[str, torch.Tensor]]:
    """Fold LoRA deltas into the base kernels: ``W' = W + (α/r)·A·B``,
    computed in f32 and cast to the serving (compute) dtype.  Returns a
    rank-0 config and ``state`` itself, updated in place (adapter entries
    removed), so only one kernel at a time exists twice.  Quantized bases
    refuse (int4 kernels cannot absorb a dense delta); serve those
    unmerged."""
    if not any(k.endswith(_LORA_LEAVES) for k in state):
        return model_cfg, state
    if getattr(model_cfg, "quantize_base", False):
        raise ServeLoadError(
            "cannot merge LoRA into an int4-quantized base; serve unmerged"
        )
    scale = model_cfg.lora.alpha / model_cfg.lora.rank
    for key in [k for k in state if k.endswith(".lora_a")]:
        prefix = key[: -len(".lora_a")]
        a, b = state.pop(key), state.pop(f"{prefix}.lora_b")
        kernel = state[f"{prefix}.kernel"].to(model_cfg.dtype)
        state[f"{prefix}.kernel"] = merge_kernel(kernel, a, b, scale)
    return merged_config(model_cfg), state


def _assemble(cfg: Any, state: dict[str, torch.Tensor], device: torch.device
              ) -> LlamaForCausalLM:
    """A model for ``cfg`` (a ``LlavaForCausalLM`` for a multimodal one)
    whose parameters ARE the tensors of ``state`` (already on ``device``):
    built on the meta device and assigned, so no second copy of the weights
    is ever allocated."""
    cls = LlavaForCausalLM if getattr(cfg, "vision", None) is not None else LlamaForCausalLM
    model = cls(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    model.inv_freqs = rope_inv_freqs(model.text_cfg, device)  # not in a state dict
    return model.requires_grad_(False).eval()


def load_serving_model(local_dir: Path | str, *, merge_lora: bool = True,
                       device=None) -> tuple[LlamaForCausalLM, dict]:
    """Build ``(model, meta)`` from a job's artifacts directory on
    ``device`` (the CUDA card unless the caller passes another).

    The port's ``Trainer`` rebuilds the model (its base drawn from the
    job's seed, as in training), the latest checkpoint's trainable tensors
    are copied in, and the optimizer state is dropped.  With
    ``merge_lora`` the adapters fold into the base kernels; without it they
    stay as the model's LoRA branch."""
    local_dir = Path(local_dir)
    spec, model_cfg, latest = _resolve_staged_spec(local_dir)
    return _rebuild(local_dir, spec, model_cfg, latest, merge_lora, device)


def load_trained_model(local_dir: Path | str, *, device=None) -> tuple[LlamaForCausalLM, dict]:
    """The trained model of a job directory with its adapters unmerged, as
    :func:`load_serving_model` builds it but without the serving guards: an
    MoE or a multimodal (LLaVA) job rebuilds too (the reference's
    ``generate_cli`` resume recipe, through the trainer, which the sanity
    generation uses)."""
    local_dir = Path(local_dir)
    spec = _read_spec(local_dir)
    model_cfg = build_model_config(spec)
    return _rebuild(local_dir, spec, model_cfg, _latest_step(local_dir), False, device)


def _rebuild(local_dir: Path, spec: dict, model_cfg: Any, latest: int, merge_lora: bool,
             device) -> tuple[LlamaForCausalLM, dict]:
    """Rebuild through the job's own trainer class (the reference's
    ``serve/loader.py:209-218``): a DPO or RLHF job serves its adapter as
    any LoRA job does; a reward job's checkpoint also carries the head
    (``head.*``), which the reward trainer restores and the model state
    leaves out — ``/generate`` serves the trunk."""
    from ..train.cli import trainer_class

    pretrained = spec.get("model", {}).get("weights_dir")
    train_cfg = build_train_config(spec)
    if train_cfg.mode == "lora" and not train_cfg.frozen_dtype:
        # serve the base in the compute dtype without building it in f32
        train_cfg = dataclasses.replace(
            train_cfg, frozen_dtype=str(model_cfg.dtype).removeprefix("torch."))
    trainer = trainer_class(train_cfg.task)(model_cfg, train_cfg, device=device)
    if pretrained and train_cfg.mode != "full":
        # the base from the HF directory, in place (no second copy), then
        # the checkpoint's trainable tensors, the reference's order; a full
        # fine-tune's checkpoint holds every weight
        trainer.load_pretrained(pretrained)
    host = CheckpointManager(local_dir / "checkpoints", sweep=False).restore(latest)
    missing = sorted(set(trainer.trainable) - set(host["trainable"]))
    if missing:
        raise ServeLoadError(
            f"checkpoint step_{latest} lacks trainable tensors {missing[:3]} "
            f"({len(missing)} in all): it does not fit this job's model")
    with torch.no_grad():
        for name, p in trainer.trainable.items():
            p.copy_(host["trainable"][name])
    state = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    dev = trainer.device
    del trainer, host  # the optimizer state and the host copy go here
    # the base in the serving dtype; the adapters keep their f32 (a cast at
    # use rounds them the same way), int4 kernels and their scales stay
    state = {k: v if k.endswith(_LORA_LEAVES + _INT4_LEAVES) else v.to(model_cfg.dtype)
             for k, v in state.items()}
    merged = False
    # an int4 base cannot absorb a dense delta: it serves unmerged (the
    # reference's ``loader.py:246-249``)
    if merge_lora and model_cfg.lora.rank > 0 and not model_cfg.quantize_base:
        model_cfg, state = merge_lora_variables(model_cfg, state)
        merged = True
    model = _assemble(model_cfg, state, dev)
    meta = {
        "preset": spec.get("model", {}).get("preset"),
        "task": train_cfg.task,
        "checkpoint_step": latest,
        "lora_merged": merged,
        "vocab_size": model_cfg.vocab_size,
        "max_seq_len": model_cfg.max_seq_len,
        "weights_dir": pretrained or None,
    }
    logger.info("serving model ready: %s", meta)
    return model, meta


def strip_lora_for_multitenant(model: LlamaForCausalLM
                               ) -> tuple[LlamaForCausalLM, dict | None, float, int]:
    """Split a loaded (unmerged) serving model into the pristine base plus
    its own adapter, for multi-tenant serving: returns ``(base_model,
    adapter | None, alpha, rank)``.  The base model's config drops to rank
    0 and shares the loaded model's tensors; the adapter (host copies of the
    LoRA factors) becomes a tenant, so the job's own fine-tune is served as
    tenant #1 while slot 0 stays the untouched base."""
    cfg = model.cfg
    state = {k: v.detach() for k, v in model.state_dict().items()}
    adapter = {k: v.to("cpu") for k, v in state.items() if k.endswith(_LORA_LEAVES)}
    if not adapter:
        return model, None, 0.0, 0
    base = {k: v for k, v in state.items() if not k.endswith(_LORA_LEAVES)}
    return (_assemble(merged_config(cfg), base, model.device), adapter,
            cfg.lora.alpha, cfg.lora.rank)


def _load_adapter_tree(local_dir: Path | str) -> tuple[dict, dict]:
    """A LoRA job's directory → ``(adapter, adapter_meta)``.  Unlike
    :func:`load_serving_model` this never builds the model or touches base
    weights: a LoRA checkpoint's trainable tensors ARE the adapter, so the
    load is one spec read plus one small ``state.pt`` read."""
    local_dir = Path(local_dir)
    spec = _read_spec(local_dir)
    model_cfg = _model_config(spec, "multimodal adapters are not servable yet")
    if model_cfg.lora.rank < 1:
        raise ServeLoadError(
            "job is not a LoRA job (lora.rank == 0): only LoRA deltas can "
            "be multiplexed onto a shared base fleet — serve it as its own "
            "model instead"
        )
    latest = _latest_step(local_dir)
    host = CheckpointManager(local_dir / "checkpoints", sweep=False).restore(latest)
    trainable = host.get("trainable") if isinstance(host, dict) else None
    adapter = {k: v for k, v in (trainable or {}).items() if k.endswith(_LORA_LEAVES)}
    if not adapter:
        raise ServeLoadError(
            "checkpoint carries no trainable (LoRA) tree — was this job "
            "trained by this stack in LoRA mode?"
        )
    meta = {
        "preset": spec.get("model", {}).get("preset"),
        "weights_dir": spec.get("model", {}).get("weights_dir") or None,
        "checkpoint_step": latest,
        "lora_rank": model_cfg.lora.rank,
        "lora_alpha": model_cfg.lora.alpha,
    }
    return adapter, meta


def stage_meta(local_dir: Path | str, *, merge_lora: bool = True) -> dict:
    """Serving meta from a job directory without building the model or
    reading weights; the eligibility guards are :func:`_resolve_staged_spec`,
    shared with :func:`load_serving_model`."""
    local_dir = Path(local_dir)
    spec, model_cfg, latest = _resolve_staged_spec(local_dir)
    merged = bool(merge_lora and model_cfg.lora.rank > 0
                  and not getattr(model_cfg, "quantize_base", False))
    return {
        "preset": spec.get("model", {}).get("preset"),
        "task": spec.get("training", {}).get("task", "sft"),
        "checkpoint_step": latest,
        "lora_merged": merged,
        "lora_rank": model_cfg.lora.rank,
        "lora_alpha": model_cfg.lora.alpha,
        "vocab_size": model_cfg.vocab_size,
        "max_seq_len": model_cfg.max_seq_len,
        "weights_dir": spec.get("model", {}).get("weights_dir") or None,
    }


# ---------------------------------------------------------------------------
# The store half: promoted prefix -> staged directory -> model
# ---------------------------------------------------------------------------


async def resolve_promoted(state, job_id: str):
    """The serve-side gate: only a COMPLETED promotion is servable.

    IN_PROGRESS/DELETING would read a half-copied prefix; FAILED and
    NOT_PROMOTED have no (trustworthy) deploy copy at all.  The error names
    the observed state so operators see *why*, not just a 409.
    """
    from ..controller.schemas import PromotionStatus

    job = await state.get_job(job_id)
    if job is None:
        raise ServeLoadError(f"job {job_id!r} not found", status=404)
    if job.promotion_status is not PromotionStatus.COMPLETED:
        raise ServeLoadError(
            f"job {job_id!r} is not servable: promotion_status is "
            f"{job.promotion_status.value!r} (serving requires 'completed' — "
            "promote the job and wait for the copy to finish)"
        )
    if not job.promotion_uri:
        raise ServeLoadError(
            f"job {job_id!r} has promotion_status=completed but no "
            "promotion_uri recorded — re-promote it"
        )
    return job


async def fetch_promoted(store, promotion_uri: str, dest_dir: Path | str) -> Path:
    """Stage the servable slice of the deploy prefix to a local directory:
    the resolved job spec + the checkpoints tree (adapter/merged exports and
    metrics are not needed to serve)."""
    import shutil

    dest = Path(dest_dir)
    # stage FRESH: leftovers from a previous load (e.g. a higher step_N from
    # a promotion that was since rolled back and re-promoted) would win the
    # latest-checkpoint pick and silently serve stale weights
    if dest.exists():
        await asyncio.to_thread(shutil.rmtree, dest, ignore_errors=True)
    prefix = promotion_uri.rstrip("/") + "/"
    objs = await store.list_prefix(promotion_uri)
    if not objs:
        raise ServeLoadError(f"no objects under promotion uri {promotion_uri}")
    n = 0
    for obj in objs:
        rel = obj["uri"][len(prefix):]
        if rel != "resolved_config.json" and not rel.startswith("checkpoints/"):
            continue
        await store.get_file(obj["uri"], dest / rel)
        n += 1
    if n == 0:
        raise ServeLoadError(
            f"promotion prefix {promotion_uri} holds no resolved_config.json/"
            "checkpoints — was this job trained by this stack?"
        )
    logger.info("staged %d promoted objects <- %s", n, promotion_uri)
    return dest


async def load_adapter(state, store, job_id: str, work_dir: Path | str, *,
                       base_meta: dict | None = None) -> tuple[dict, dict]:
    """Stage ONLY a promoted LoRA job's adapter for multi-tenant serving:
    ``(adapter, meta)`` ready for ``AdapterRegistry.register``.
    ``base_meta`` (the serving session's meta) guards against serving an
    adapter on the wrong base: preset and pretrained weights must match."""
    import shutil
    import uuid

    job = await resolve_promoted(state, job_id)
    job_dir = Path(work_dir) / job_id
    local = await fetch_promoted(
        store, job.promotion_uri, job_dir / f"adapter-{uuid.uuid4().hex[:8]}"
    )
    try:
        adapter, meta = await asyncio.to_thread(_load_adapter_tree, local)
    finally:
        await asyncio.to_thread(shutil.rmtree, local, ignore_errors=True)
    if base_meta is not None:
        for field in ("preset", "weights_dir"):
            if meta.get(field) != base_meta.get(field):
                raise ServeLoadError(
                    f"adapter job {job_id!r} was trained on "
                    f"{field}={meta.get(field)!r} but the base fleet serves "
                    f"{field}={base_meta.get(field)!r} — an adapter only "
                    "composes with the exact base it was trained against"
                )
        if base_meta.get("lora_merged"):
            raise ServeLoadError(
                "the base fleet serves MERGED weights; multi-tenant "
                "adapters need the pristine base — reload it with "
                "serve_merge_lora=false"
            )
    meta["job_id"] = job_id
    meta["promotion_uri"] = job.promotion_uri
    return adapter, meta


async def stage_for_workers(state, store, job_id: str, work_dir: Path | str, *,
                            merge_lora: bool = True) -> tuple[Path, dict]:
    """resolve → stage → meta, WITHOUT loading weights into this process.
    The staged dir is returned (not removed: a reader that rebuilds the
    weights from it needs it for as long as it serves) along with the meta
    :func:`load_promoted` produces."""
    import uuid

    job = await resolve_promoted(state, job_id)
    job_dir = Path(work_dir) / job_id
    local = await fetch_promoted(
        store, job.promotion_uri, job_dir / f"workers-{uuid.uuid4().hex[:8]}"
    )
    meta = await asyncio.to_thread(stage_meta, local, merge_lora=merge_lora)
    meta["job_id"] = job_id
    meta["promotion_uri"] = job.promotion_uri
    return local, meta


async def load_promoted(state, store, job_id: str, work_dir: Path | str, *,
                        merge_lora: bool = True, device=None
                        ) -> tuple[LlamaForCausalLM, dict]:
    """resolve → stage → load, the whole serve-side path for one job, on
    ``device`` (the CUDA card unless the caller passes another).

    Each load stages into its OWN ``stage-<nonce>`` directory and removes it
    once the weights are loaded, so two racing loads for one job never
    interleave writes under a shared prefix."""
    import shutil
    import uuid

    job = await resolve_promoted(state, job_id)
    job_dir = Path(work_dir) / job_id
    local = await fetch_promoted(
        store, job.promotion_uri, job_dir / f"stage-{uuid.uuid4().hex[:8]}"
    )
    try:
        model, meta = await asyncio.to_thread(
            load_serving_model, local, merge_lora=merge_lora, device=device
        )
    finally:
        await asyncio.to_thread(shutil.rmtree, local, ignore_errors=True)
    meta["job_id"] = job_id
    meta["promotion_uri"] = job.promotion_uri
    return model, meta
