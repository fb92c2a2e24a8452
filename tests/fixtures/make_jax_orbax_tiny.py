"""Write ``tests/fixtures/jax_orbax_tiny/``: a checkpoint the JAX package's
own ``CheckpointManager`` writes in orbax's OCDBT layout, with what the
port needs to resume it and the JAX package's losses after the resume.

    JAX_PLATFORMS=cpu python tests/fixtures/make_jax_orbax_tiny.py

The job is ``tiny-test`` LoRA (rank 4, f32, the JAX trainer's scanned
layers) on seeded numpy inputs, as ``tests/test_torch_checkpoint.py``
drives it.  The script writes:

* ``checkpoints/step_2/`` — the JAX trainer's state after 2 steps, saved by
  ``finetune_controller_tpu.train.checkpoint.CheckpointManager.save`` (one
  process: ``ocp.StandardCheckpointer``) with its manifest;
* ``large/step_0/`` — one bf16 array of 512 x 1024 values (1 MB raw) saved
  by the same manager, so that a decoder's rate is read on a frame of real
  size;
* ``base.npz`` — the frozen base and initial adapter as the port's state
  dict (``models/convert.from_flax``), f32;
* ``batches.npz`` — the 4 packed batches of the run;
* ``expected.json`` — the run's settings and the JAX package's own resume:
  its trainer restored from ``step_2`` through the same manager's
  ``restore`` and stepped on batches 3-4 (losses of steps 3 and 4).

The port reads all of it without JAX (``chip_smoke.py`` phase O on the
card, ``tests/test_torch_checkpoint.py`` on the CPU).  The whole fixture
stays under 2 MB.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from finetune_controller_tpu.data.loader import batches_from_tokens, pack_documents  # noqa: E402
from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS  # noqa: E402
from finetune_controller_tpu.models.lora import LoRAConfig  # noqa: E402
from finetune_controller_tpu.train.checkpoint import CheckpointManager  # noqa: E402
from finetune_controller_tpu.train.trainer import TrainConfig, Trainer  # noqa: E402

OUT = Path(__file__).resolve().parent / "jax_orbax_tiny"
SEQ = 16
TRAIN_KW = dict(mode="lora", learning_rate=0.01, warmup_steps=1, batch_size=4, seq_len=SEQ,
                prefetch=0, log_every=1, heartbeat_interval_s=0, total_steps=4,
                checkpoint_every=100)
RANK = 4
SAVE_STEP = 2
LARGE_SHAPE = (512, 1024)


def packed_batches(seed: int, batch_size: int, n: int) -> list[dict]:
    """n packed batches of documents of 3-20 tokens, as the loader packs them."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, rng.integers(3, 21)).tolist() for _ in range(60)]
    tokens, segments, flags = pack_documents(docs, SEQ)
    it = batches_from_tokens(tokens, segments, batch_size, seed=seed, loss_flags=flags)
    return [{k: np.asarray(v) for k, v in next(it).items()} for _ in range(n)]


def noisy(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32), tree)


def main() -> None:
    from finetune_controller_tpu_torch.models.convert import from_flax
    from finetune_controller_tpu_torch.models.llama import PRESETS as PORT_PRESETS
    from finetune_controller_tpu_torch.models.lora import LoRAConfig as PortLoRAConfig

    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    cfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=LoRAConfig(rank=RANK))
    trainer = Trainer(cfg, TrainConfig(**TRAIN_KW))
    state = trainer.init_state()
    frozen = noisy(jax.device_get(state.frozen), 5)
    trainable = noisy(jax.device_get(state.trainable), 6)
    state = state.replace(frozen=frozen, trainable=trainable, opt_state=trainer.tx.init(trainable))
    batches = packed_batches(7, TRAIN_KW["batch_size"], TRAIN_KW["total_steps"])
    for batch in batches[:SAVE_STEP]:
        state, _ = trainer.step(state, dict(batch))
    host = trainer.state_to_host(state)
    ckpt = CheckpointManager(str(OUT / "checkpoints"))
    ckpt.save(SAVE_STEP, host, blocking=True, manifest=trainer._build_manifest(SAVE_STEP, host))

    # the JAX package's own resume: a fresh state, restored through the
    # manager, stepped on the remaining batches
    resumed = trainer.init_state()
    resumed = resumed.replace(frozen=frozen, trainable=trainable,
                              opt_state=trainer.tx.init(trainable))
    restored = CheckpointManager(str(OUT / "checkpoints")).restore(
        SAVE_STEP, like=trainer.state_to_host(resumed))
    resumed = resumed.replace(step=jnp.asarray(restored["step"], jnp.int32),
                              trainable=restored["trainable"], opt_state=restored["opt_state"])
    losses = []
    for batch in batches[SAVE_STEP:]:
        resumed, metrics = trainer.step(resumed, dict(batch))
        losses.append(float(metrics["loss"]))

    rng = np.random.default_rng(11)
    large = jnp.asarray(rng.standard_normal(LARGE_SHAPE), dtype=jnp.bfloat16)
    CheckpointManager(str(OUT / "large")).save(0, {"x": large}, blocking=True)

    port_cfg = PORT_PRESETS["tiny-test"].replace(lora=PortLoRAConfig(rank=RANK))
    base = from_flax({**frozen, "lora": trainable}, port_cfg)
    np.savez(OUT / "base.npz", **{k: v.float().numpy() for k, v in base.items()})
    np.savez(OUT / "batches.npz", **{f"{i}/{k}": v for i, b in enumerate(batches)
                                     for k, v in b.items()})
    (OUT / "expected.json").write_text(json.dumps({
        "preset": "tiny-test", "lora_rank": RANK, "dtype": "float32", "train": TRAIN_KW,
        "save_step": SAVE_STEP, "resumed_steps": list(range(SAVE_STEP + 1,
                                                          TRAIN_KW["total_steps"] + 1)),
        "losses": losses, "large_shape": list(LARGE_SHAPE),
    }, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT} ({total} bytes); resumed losses {losses}")
    if total > 2 * 1024 * 1024:
        raise SystemExit(f"fixture is {total} bytes, above 2 MB")


if __name__ == "__main__":
    main()
