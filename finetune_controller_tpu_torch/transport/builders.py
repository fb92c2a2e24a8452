"""Worker payload builders: how a worker process rebuilds its serving model
WITHOUT the parent shipping weights over the wire.

A worker spec names a builder (``"deploy_dir"``, ``"tiny_test"``,
``"rollout_base"``, or a fully qualified ``"package.module:callable"``)
plus kwargs; the builder returns the model
:class:`~..serve.engine.BatchEngine` serves.  Every built-in takes
``device`` (the CUDA card unless the spec names another):

* ``deploy_dir`` — rebuild from a staged promoted prefix exactly as the
  in-process loader does (``serve/loader.py::load_serving_model``), so a
  process-mode fleet and an in-process one decode alike from the same
  artifacts;
* ``tiny_test`` — the seeded tiny preset: the same ``seed`` gives the same
  weights in every process on one device (the port's draw, not the JAX
  package's);
* ``rollout_base`` — an RLHF learner's frozen base as the JAX package's
  ``prefs/rollout_plane.py::write_rollout_base`` writes it
  (``rollout_base/{model.json,params.msgpack}``), read with the port's own
  flax-msgpack coder and ``models/convert.py``.

Builders run INSIDE the worker process; torch and the model stack are
imported lazily so the spec-parsing half stays light.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable


def tiny_test(preset: str = "tiny-test", seed: int = 0, dtype: str = "",
              device: str = "cuda") -> Any:
    """The seeded tiny model (tests, CPU runs): same ``seed`` ⇒ the same
    weights in every process on the same device."""
    import torch

    from ..models.llama import PRESETS, LlamaForCausalLM, init_random_

    cfg = PRESETS[preset]
    if dtype:
        cfg = cfg.replace(dtype=getattr(torch, dtype), param_dtype=getattr(torch, dtype))
    model = LlamaForCausalLM(cfg, device=device)
    init_random_(model, seed)
    return model.requires_grad_(False).eval()


def deploy_dir(dir: str, merge_lora: bool = True, multi_tenant: bool = False,
               device: str | None = None) -> Any:
    """Rebuild the serving model from a staged promoted prefix (the parent's
    ``serve/loader.py::stage_for_workers`` output, shared read-only by every
    worker of the fleet).  ``multi_tenant`` strips the job's own LoRA: the
    PARENT registry owns that adapter and installs it through the
    registry-sync RPC like any other tenant."""
    from ..serve.loader import load_serving_model, strip_lora_for_multitenant

    model, _meta = load_serving_model(
        dir, merge_lora=merge_lora and not multi_tenant, device=device
    )
    if multi_tenant:
        model, _tree, _alpha, _rank = strip_lora_for_multitenant(model)
    return model


def rollout_base(dir: str, device: str | None = None) -> Any:
    """An RLHF learner's FROZEN BASE for a remote rollout actor, from
    ``<dir>/rollout_base/`` (model spec JSON + flax-msgpack params, written
    once by the learner): adapter deltas then arrive over the wire, so base
    weights never do."""
    import json
    import logging
    import os
    import time

    import torch

    from ..device import resolve_device
    from ..models.convert import from_flax, merged_config
    from ..serve.loader import _assemble
    from ..train.cli import build_model_config
    from ..utils import flax_msgpack

    base = os.path.join(dir, "rollout_base")
    with open(os.path.join(base, "model.json")) as f:
        model_spec = json.load(f)
    cfg = build_model_config({"model": model_spec})
    if getattr(cfg, "vision", None) is not None:
        raise ValueError("rollout_base only supports text-only policies")
    t0 = time.perf_counter()
    with open(os.path.join(base, "params.msgpack"), "rb") as f:
        params = flax_msgpack.restore(f.read())
    t1 = time.perf_counter()
    cfg = merged_config(cfg)  # the base alone: adapters arrive as tenants
    dev = resolve_device(device)
    state = {k: v.to(dev, cfg.dtype if v.is_floating_point() else v.dtype)
             for k, v in from_flax({"params": params}, cfg).items()}
    del params
    logging.getLogger(__name__).info(
        "rollout base: %.2f GB read in %.1f s, on %s in %.1f s more",
        sum(v.nbytes for v in state.values()) / 1e9, t1 - t0, dev, time.perf_counter() - t1)
    with torch.no_grad():
        return _assemble(cfg, state, dev)


_BUILTINS: dict[str, Callable[..., Any]] = {
    "tiny_test": tiny_test,
    "deploy_dir": deploy_dir,
    "rollout_base": rollout_base,
}


def resolve_builder(name: str) -> Callable[..., Any]:
    """Builder lookup: a built-in name or ``module:attr``.  The spec file is
    written by this process's own transport layer, so this is
    configuration, not an untrusted-input surface."""
    if name in _BUILTINS:
        return _BUILTINS[name]
    if ":" not in name:
        raise ValueError(
            f"unknown payload builder {name!r} "
            f"(built-ins: {sorted(_BUILTINS)}; or use 'module:callable')"
        )
    mod_name, _, attr = name.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr, None)
    if not callable(fn):
        raise ValueError(f"payload builder {name!r} is not callable")
    return fn
