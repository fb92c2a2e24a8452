"""Fidelity proof: a real-weights, real-data fine-tune, end to end (the
port's counterpart of the reference's ``fidelity.py``).

Every throughput number elsewhere runs on random weights and synthetic
tokens.  The proof checks the product instead:

1. **Pretrain a base** (:func:`pretrain_base`): ``tiny-test`` trained in
   full mode on real English (stdlib docstrings, ``data/corpus.py``; no
   network) until it models the text, exported through
   ``models/hf_export.py`` as an HF checkpoint directory — the stand-in for
   a pretrained base from the hub.
2. **Fine-tune through the product** (:func:`run_proof`): the base is fed
   to the port's controller path — dataset upload, job submission through
   ``task_builder``, the local backend's subprocess trainer
   (``train/cli.py``), monitor reconciliation, artifact sync — as a LoRA SFT
   job on the instruction rows of :func:`build_sft_jsonl`, whose
   completions open with :data:`SFT_PREFIX`.
3. **Check** that the step-0 loss from the base is far below the
   random-init loss, that the final loss is far below step 0, and that
   greedy generation (``models/generate_cli.py`` on the job's synced
   artifacts) on a HELD-OUT topic flips to the SFT style.

``tests/test_torch_fidelity.py`` runs the proof on the CPU at the JAX CPU
test's scale; phase F of ``chip_smoke.py`` runs it on the card at the
default scale.
"""

from __future__ import annotations

import asyncio
import contextlib
import csv
import io
import json
import logging
from pathlib import Path
from typing import Any

from pydantic import Field

from .controller.examples import LoRASFTArguments, TinyTestLoRA

logger = logging.getLogger(__name__)


class FidelityArguments(LoRASFTArguments):
    """The smoke spec's arguments plus the metrics cadence — the proof reads
    the step-1 loss, so every step must log."""

    log_every: int = Field(1, ge=1, description="Metrics cadence (steps)")


class FidelityLoRA(TinyTestLoRA):
    """LoRA SFT from a locally pretrained real-text base; the per-run base
    directory is bound by subclassing (``pretrained_weights_dir`` is part of
    the class-level contract, as a registered spec pins its hub
    checkpoint)."""

    model_name = "fidelity-tiny-lora"
    description = "LoRA SFT from a locally pretrained real-text base"

    training_arguments: FidelityArguments

#: SFT response style: every completion opens with this frame — trivially
#: learnable, unmistakably absent from stdlib-docstring English, so the
#: before/after generation contrast is unambiguous
SFT_PREFIX = "Aye, "

_TOPICS = [
    "the weather", "sailing ships", "buried treasure", "the open sea",
    "your parrot", "the captain", "a treasure map", "the island",
    "the crew", "the storm", "the harbor", "the compass", "the rigging",
    "the lookout", "the galley", "the anchor", "the tide", "the moon",
    "the cannons", "the flag",
]
#: topics never written to the SFT dataset — generation is probed on these
HOLDOUT_TOPICS = ["the kraken", "the lighthouse"]


def sft_prompt(topic: str) -> str:
    return f"<|user|>\nTell me about {topic}.\n<|assistant|>\n"


def sft_completion(topic: str) -> str:
    return f"{SFT_PREFIX}{topic} be a fine thing to know about, arr!\n"


def build_sft_jsonl(path: Path | str, *, rows_per_topic: int = 12) -> bytes:
    """Instruction rows (``prompt``/``completion`` — loss counts completion
    tokens only, ``data/loader.py``).  Returns the bytes written."""
    lines = []
    for r in range(rows_per_topic):
        for topic in _TOPICS:
            # vary the question frame so the learnable signal is the response
            # style, not one memorized byte sequence
            q = [
                f"<|user|>\nTell me about {topic}.\n<|assistant|>\n",
                f"<|user|>\nWhat do you know of {topic}?\n<|assistant|>\n",
                f"<|user|>\nDescribe {topic} for me.\n<|assistant|>\n",
            ][r % 3]
            lines.append(json.dumps(
                {"prompt": q, "completion": sft_completion(topic)}
            ))
    data = ("\n".join(lines) + "\n").encode()
    Path(path).write_bytes(data)
    return data


def _read_metrics_csv(path: Path) -> list[dict[str, float]]:
    with open(path) as f:
        return [
            {k: float(v) for k, v in row.items() if v != ""}
            for row in csv.DictReader(f)
        ]


def pretrain_base(
    work_dir: Path | str,
    *,
    steps: int = 600,
    corpus_bytes: int = 400_000,
    batch_size: int = 16,
    seq_len: int = 128,
    learning_rate: float = 1e-3,
    preset: str = "tiny-test",
    seed: int = 0,
    device=None,
) -> dict[str, Any]:
    """Pretrain ``preset`` on real English and export it as an HF checkpoint
    (one f32 ``model.safetensors`` + ``config.json``) on ``device`` (the
    CUDA card unless the caller passes another).

    Runs the trainer in ``full`` mode (no adapters — this *builds* the base
    the fine-tune will consume) and exports with
    ``export_merged_checkpoint``."""
    from .data.corpus import write_corpus_jsonl
    from .data.loader import jsonl_token_batches
    from .models.hf_export import export_merged_checkpoint
    from .models.llama import PRESETS
    from .train.trainer import TrainConfig, Trainer

    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    corpus_path = work / "corpus.jsonl"
    n_bytes = write_corpus_jsonl(corpus_path, corpus_bytes)

    cfg = PRESETS[preset]
    tcfg = TrainConfig(
        mode="full",
        learning_rate=learning_rate,
        warmup_steps=min(20, max(1, steps // 20)),
        total_steps=steps,
        batch_size=batch_size,
        seq_len=seq_len,
        seed=seed,
        log_every=1,
        checkpoint_every=steps,  # only the final state matters here
    )
    trainer = Trainer(cfg, tcfg, device=device)
    batches = jsonl_token_batches(
        str(corpus_path), batch_size=batch_size, seq_len=seq_len, seed=seed
    )
    art = work / "pretrain_artifacts"
    trainer.fit(batches, str(art), resume=False)
    rows = _read_metrics_csv(art / "metrics.csv")
    first_loss, final_loss = rows[0]["loss"], rows[-1]["loss"]

    base_dir = work / "pretrained_base"
    export_merged_checkpoint(cfg, trainer.model.state_dict(), base_dir)
    logger.info(
        "pretrained base: loss %.3f -> %.3f over %d steps (%d corpus bytes) -> %s",
        first_loss, final_loss, steps, n_bytes, base_dir,
    )
    return {
        "base_dir": str(base_dir),
        "corpus_bytes": n_bytes,
        "pretrain_steps": steps,
        "pretrain_first_loss": first_loss,
        "pretrain_final_loss": final_loss,
    }


def _generate_text(model, prompt: str, max_new_tokens: int) -> str:
    """Greedy byte-level generation from ``model`` (KV-cached)."""
    import torch

    from .models.generate import cached_generate

    ids = list(prompt.encode())
    out = cached_generate(model, torch.tensor([ids]), max_new_tokens=max_new_tokens)
    new = out[0, len(ids):].tolist()
    return bytes(i for i in new if 0 <= i < 256).decode("utf-8", errors="replace")


async def _run_controller_job(
    work: Path,
    base_dir: str,
    sft_bytes: bytes,
    *,
    steps: int,
    batch_size: int,
    seq_len: int,
    lora_rank: int,
    learning_rate: float,
    deadline_s: float,
    device: str,
) -> dict[str, Any]:
    """Submit the LoRA job through the port's control plane (``task_builder``
    → local backend subprocess → monitor) on a one-chip flavor of
    ``device``'s runtime (``cpu``, or ``cuda``: the card) and return its
    metrics and a local copy of the synced artifacts."""
    from .controller.backends.local import LocalProcessBackend
    from .controller.datasets import upload_dataset_bytes
    from .controller.devices import DeviceCatalog, DeviceFlavor, FlavorQuota
    from .controller.monitor import JobMonitor
    from .controller.objectstore import LocalObjectStore
    from .controller.schemas import DatabaseStatus, JobInput
    from .controller.statestore import StateStore
    from .controller.task_builder import DatasetInput, task_builder

    # bind the per-run base dir; no new annotations, so the inherited
    # pydantic fields resolve in this module's globals
    class _BoundFidelityLoRA(FidelityLoRA):
        pretrained_weights_dir = base_dir

    state = StateStore(work / "state")
    store = LocalObjectStore(work / "objects")
    runtime = "cpu" if device == "cpu" else "cuda"
    catalog = DeviceCatalog(
        flavors=[DeviceFlavor(name="chip-1", generation=runtime, hosts=1,
                              chips_per_host=1, runtime=runtime, queue="q")],
        quotas=[FlavorQuota(flavor="chip-1", nominal_chips=1)],
        default_flavor="chip-1",
    )
    backend = LocalProcessBackend(work / "sandboxes", store, catalog, sync_interval_s=0.5)
    monitor = JobMonitor(state, store, backend, interval_s=0.1)
    await state.connect()
    try:
        ds = await upload_dataset_bytes(
            store, state, user_id="fidelity", filename="sft.jsonl",
            data=sft_bytes, bucket="datasets",
        )
        spec = _BoundFidelityLoRA(training_arguments=FidelityArguments(
            learning_rate=learning_rate, total_steps=steps,
            warmup_steps=max(1, steps // 20), batch_size=batch_size,
            seq_len=seq_len, lora_rank=lora_rank, log_every=1,
        ))
        job = JobInput(job_id="fidelity-1", user_id="fidelity",
                       model_name=spec.model_name, device="chip-1", arguments={})
        await task_builder(
            job, spec, DatasetInput(dataset_id=ds.dataset_id),
            state=state, store=store, backend=backend, catalog=catalog,
            datasets_bucket="datasets", artifacts_bucket="artifacts",
        )
        loop = asyncio.get_running_loop()
        deadline = loop.time() + deadline_s
        while True:
            await monitor.tick()
            rec = await state.get_job("fidelity-1")
            if rec.status.is_final:
                break
            if loop.time() > deadline:
                raise TimeoutError(f"fidelity job not final in {deadline_s}s: {rec}")
            await asyncio.sleep(0.3)
        if rec.status is not DatabaseStatus.SUCCEEDED:
            raise RuntimeError(f"fidelity job failed: {rec}")

        metrics = await state.get_metrics("fidelity-1")
        # the product-path artifacts: the synced tree pulled back out of the
        # object store, what a user's serving pipeline would fetch
        local = work / "fetched_artifacts"
        for entry in await store.list_prefix(rec.artifacts_uri):
            rel = entry["uri"][len(rec.artifacts_uri) + 1:]
            await store.get_file(entry["uri"], local / rel)
        return {"records": metrics.records, "artifacts_dir": str(local)}
    finally:
        await backend.close()
        await state.close()


def run_proof(
    work_dir: Path | str,
    *,
    pretrain_steps: int = 600,
    corpus_bytes: int = 400_000,
    sft_steps: int = 120,
    batch_size: int = 16,
    seq_len: int = 128,
    lora_rank: int = 8,
    sft_learning_rate: float = 3e-3,
    max_new_tokens: int = 24,
    job_deadline_s: float = 600.0,
    base: dict[str, Any] | None = None,
    device=None,
) -> dict[str, Any]:
    """The whole proof through the controller; returns (and writes) the
    fidelity record.  Pass ``base`` (a previous :func:`pretrain_base`
    result) to reuse a base already built; ``device`` is where the base is
    pretrained, the reference losses evaluated and the job trained (the
    card unless the caller passes ``"cpu"``)."""
    from .data.loader import jsonl_token_batches
    from .device import resolve_device
    from .models.generate_cli import main as generate_main
    from .models.llama import PRESETS
    from .models.lora import LoRAConfig
    from .train.trainer import TrainConfig, Trainer

    device = resolve_device(device)
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    if base is None:
        base = pretrain_base(
            work / "base", steps=pretrain_steps, corpus_bytes=corpus_bytes,
            batch_size=batch_size, seq_len=seq_len, device=device,
        )

    sft_path = work / "sft.jsonl"
    sft_bytes = build_sft_jsonl(sft_path)
    probe_prompt = sft_prompt(HOLDOUT_TOPICS[0])

    # the reference losses and the "before" generation: fresh adapters
    # (B = 0) are the base's behaviour
    trainer = Trainer(PRESETS["tiny-test"].replace(lora=LoRAConfig(rank=lora_rank)),
                      TrainConfig(mode="lora", batch_size=batch_size, seq_len=seq_len,
                                  eval_steps=4), device=device)

    def eval_loss() -> float:
        it = jsonl_token_batches(str(sft_path), batch_size=batch_size, seq_len=seq_len, seed=7)
        return trainer.evaluate(it)["eval_loss"]

    random_init_loss = eval_loss()
    trainer.load_pretrained(base["base_dir"])
    base_sft_loss = eval_loss()
    before_text = _generate_text(trainer.model, probe_prompt, max_new_tokens)
    del trainer

    # the product path
    job = asyncio.run(_run_controller_job(
        work, base["base_dir"], sft_bytes,
        steps=sft_steps, batch_size=batch_size, seq_len=seq_len,
        lora_rank=lora_rank, learning_rate=sft_learning_rate,
        deadline_s=job_deadline_s, device=device.type,
    ))
    records = job["records"]
    step0_loss = records[0]["loss"]
    final_loss = records[-1]["loss"]

    # the "after" generation from the job's own artifacts (generate_cli, the
    # operator surface)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate_main(["--artifacts", job["artifacts_dir"], "--prompt", probe_prompt,
                       "--max-new-tokens", str(max_new_tokens), "--device", str(device)])
    after_text = json.loads(buf.getvalue().strip().splitlines()[-1])["text"]

    record = {
        "kind": "fidelity",
        **{k: v for k, v in base.items() if k != "base_dir"},
        "sft_steps": sft_steps,
        "lora_rank": lora_rank,
        "random_init_loss": random_init_loss,
        "base_step0_loss": step0_loss,
        "base_eval_loss": base_sft_loss,
        "final_loss": final_loss,
        "probe_prompt": probe_prompt,
        "before_generation": before_text,
        "after_generation": after_text,
        "checks": {
            "base_transfers": step0_loss < 0.75 * random_init_loss,
            "finetune_learns": final_loss < 0.75 * step0_loss,
            "style_acquired": after_text.startswith(SFT_PREFIX)
                              and not before_text.startswith(SFT_PREFIX),
        },
    }
    record["passed"] = all(record["checks"].values())
    out = Path(job["artifacts_dir"]) / "fidelity_record.json"
    out.write_text(json.dumps(record, indent=2))
    record["record_path"] = str(out)
    logger.info(
        "fidelity: random %.3f -> base step0 %.3f -> final %.3f; "
        "after starts with %r: %s",
        random_init_loss, step0_loss, final_loss, SFT_PREFIX, record["passed"],
    )
    return record
