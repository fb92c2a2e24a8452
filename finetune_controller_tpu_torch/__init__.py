"""finetune_controller_tpu_torch — the PyTorch/CUDA port.

The JAX package ``finetune_controller_tpu`` is the reference; this package
holds its own counterparts of the modules it needs and imports nothing from
it (nor ``jax``/``flax``).  The slices ported so far are paged
continuous-batching serving, LoRA SFT training through the spec CLI,
serving what it trains (multi-tenant adapters, a host KV tier, a replica
fleet and router), HF checkpoints in and out with held-out evaluation,
the trainer's observability and the fidelity proof, the control plane
that submits, schedules, trains, promotes and serves jobs over HTTP, int4
QLoRA, MoE, LLaVA, the preference plane, fault-tolerant training, and
serving from worker processes with warm trainer starts:

* ``models`` — ``LlamaConfig``/``PRESETS``, the decoder as ``nn.Module``s
  (serving and training forwards, remat, LoRA dropout), the flax-tree
  converters and LoRA merge, the sampling oracle and ``generate_cli``, the
  safetensors reader/writer and the HF import and export;
* ``ops`` — the plain attention functions, the ``FTC_PAGED_ATTN`` and
  ``FTC_FLASH_ATTN`` seams, and the hand-written CUDA kernels
  (``ops/kernels``, sources in ``csrc/``): paged attention, and the flash
  attention forward, dQ and dK/dV;
* ``serve`` — the page pool and host tier, prefix cache, ``BatchEngine``
  (paged or unpaged, multi-tenant), the asyncio ``Batcher``, the adapter
  registry, the replica fleet and router, and the checkpoint loader;
* ``resilience`` — failure classification, retry backoff, the serve
  fault injector, the trainer's heartbeat and the retry supervisor;
* ``obs`` — lifecycle events, spans and their trace assembly, the
  step-phase clock and the Prometheus hub;
* ``data`` and ``train`` — the packing loader, the stdlib corpus, the
  trainer, optimizer, checkpoints and ``python -m
  finetune_controller_tpu_torch.train.cli``;
* ``fidelity`` — the fidelity proof's base pretraining and SFT data;
* ``controller`` and ``sched`` — the HTTP server (on the stdlib
  ``controller/web.py``), state and object stores, the local backend that
  launches the trainer CLI, the monitor, promotion, and the fair-share
  scheduler; ``serve/service.py`` serves promoted jobs over HTTP.
* ``prefs`` — the preference plane: the DPO trainer, the Bradley–Terry
  reward model and the in-process RLHF-lite actor/learner loop, on the
  pair batches of ``data/preference.py``; ``utils/flax_msgpack.py`` writes
  and reads flax's msgpack format (the reward head's file);
* ``transport`` — serve replicas as worker processes behind a framed RPC
  socket (wire, worker, client, process spawn, payload builders);
  ``train/warm_worker.py`` is the local backend's pre-warmed trainer.

Submodules load lazily, so ``import finetune_controller_tpu_torch`` costs
nothing until a name is used.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_LAZY = {
    "resolve_device": ".device",
    "LlamaConfig": ".models.llama",
    "LlamaForCausalLM": ".models.llama",
    "PRESETS": ".models.llama",
    "BatchEngine": ".serve.engine",
    "EngineConfig": ".serve.engine",
    "GenRequest": ".serve.engine",
    "Batcher": ".serve.batcher",
    "ReplicaFleet": ".serve.fleet",
    "ReplicaRouter": ".serve.router",
    "load_serving_model": ".serve.loader",
    "TrainConfig": ".train.trainer",
    "Trainer": ".train.trainer",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module, __name__), name)
