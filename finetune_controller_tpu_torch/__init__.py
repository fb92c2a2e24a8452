"""finetune_controller_tpu_torch — the PyTorch/CUDA port of the serving path.

The JAX package ``finetune_controller_tpu`` is the reference; this package
holds its own counterparts of the modules it needs and imports nothing from
it (nor ``jax``/``flax``).  The slice ported so far is paged
continuous-batching serving:

* ``models`` — ``LlamaConfig``/``PRESETS``, the decoder as ``nn.Module``s,
  the flax-tree converter and LoRA merge, the sampling oracle;
* ``ops`` — the plain attention functions, the ``FTC_PAGED_ATTN`` seam, and
  the hand-written CUDA paged-attention kernel (``ops/kernels``, sources in
  ``csrc/``);
* ``serve`` — the page pool, prefix cache, paged ``BatchEngine`` and the
  asyncio ``Batcher``.

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
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module, __name__), name)
