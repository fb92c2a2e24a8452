"""Carry weights from the reference's flax variables into the port.

``from_flax(variables, cfg)`` takes the JAX variables tree as nested dicts of
numpy arrays — the ``params`` collection and, when present, ``lora`` and
the multi-tenant ``tenants`` stacks — and returns the port's state dict
(``LlamaForCausalLM.load_state_dict``).  Both layer layouts of the
reference are read:

* scanned (``scan_layers=True``): ``params/blocks/block/<...>`` with a
  leading layer axis L on every leaf (``llama.py:773-783``);
* unscanned: ``params/layer_{i}/<...>``.

Kernels keep flax's ``(in, out)`` layout — the port's ``LoRADense`` computes
``x @ W`` — so no leaf is transposed.  An int4 base (``quantize_base``)
carries ``kernel_packed``/``kernel_scales`` in place of ``kernel``; an MoE
layer carries ``moe/{router_kernel, experts_{gate,up,down}}`` (or their
``_packed``/``_scales`` pairs) in place of ``mlp``, each with the layer
axis in the scanned layout.  bf16 leaves (the int4 scales) cross as bf16.  ``lm_head`` is absent for tied
embeddings (the head reuses ``embed_tokens.embedding``); q/k/v biases come
along where the config has them.

A multimodal config (``models/multimodal.LlavaConfig``) adds the
``vision_tower`` and ``projector_fc1``/``projector_fc2`` subtrees beside the
text decoder's leaves: the patch convolution's flax ``HWIO`` kernel becomes
torch's ``OIHW``, and the attention's ``(d, H, hd)`` / ``(H, hd, d)``
kernels and ``(H, hd)`` biases become ``(d, d)`` ``(in, out)`` kernels and
``(d,)`` biases; flax's ``block_{i}`` is the port's ``blocks.{i}``.

``to_flax(state, cfg)`` is the inverse: the port's state dict back into a
flax variables tree of numpy arrays, in the layout ``cfg.scan_layers``
names, so tests can compare what the port trained with the JAX tree.

``adapter_from_flax(lora, cfg)`` carries one adapter's ``lora`` tree into
the port's adapter form: the flat ``layers.{i}.{attn|mlp}.{proj}.lora_a`` /
``lora_b`` dict a LoRA checkpoint's ``trainable`` holds, which
``serve/adapters.py`` installs into tenant stacks.

``merge_lora(cfg, state)`` folds LoRA deltas into the base kernels, the
counterpart of ``serve/loader.py:merge_lora_variables``.

``trainable_from_flax(leaves)`` names a reference trainer's ``trainable``
leaves (flat ``/`` paths, :func:`flat_paths`) as the port's trainer names
its trained tensors; the checkpoint reader (``train/checkpoint.py``) maps
the JAX package's ``state.msgpack`` and its manifest through it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from .lora import LoRAConfig
from .moe import EXPERT_KERNELS

#: the seven projections, as ``module/projection`` paths of a layer
_PROJECTIONS = ("attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj",
                "mlp/gate_proj", "mlp/up_proj", "mlp/down_proj")


def _layer_leaves(cfg) -> dict[str, tuple[str, ...]]:
    """A layer's ``module -> leaves`` of the ``params`` collection for
    ``cfg`` (int4 kernels as their packed/scales pairs; ``moe`` in place of
    ``mlp`` for an MoE config)."""
    quant = ("_packed", "_scales") if getattr(cfg, "quantize_base", False) else ("",)
    kernel = tuple(f"kernel{q}" for q in quant)
    out: dict[str, tuple[str, ...]] = {"attn_norm": ("scale",), "mlp_norm": ("scale",)}
    for module in _PROJECTIONS[:3]:
        out[module] = kernel + ("bias",)
    out["attn/o_proj"] = kernel
    if getattr(cfg, "n_experts", 0):
        out["moe"] = ("router_kernel",) + tuple(f"{n}{q}" for n in EXPERT_KERNELS for q in quant)
    else:
        for module in _PROJECTIONS[4:]:
            out[module] = kernel
    return out


def _walk(tree: Mapping, path: str):
    for key in path.split("/"):
        if not isinstance(tree, Mapping) or key not in tree:
            return None
        tree = tree[key]
    return tree


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a bf16 leaf of utils/flax_msgpack.py
        return x.clone()
    # np.array copies: the state dict must not alias the caller's buffers
    x = np.array(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _layer_trees(collection: Mapping | None, n_layers: int) -> list[Mapping | None]:
    """Per-layer subtrees of one flax collection, for either layout."""
    if collection is None:
        return [None] * n_layers
    stacked = _walk(collection, "blocks/block")
    if stacked is not None:
        def index(tree, i):
            if isinstance(tree, Mapping):
                return {k: index(v, i) for k, v in tree.items()}
            return tree[i] if isinstance(tree, torch.Tensor) else np.asarray(tree)[i]

        return [index(stacked, i) for i in range(n_layers)]
    return [collection.get(f"layer_{i}") for i in range(n_layers)]


def _vision_leaves(vcfg) -> Iterator[tuple[str, str, Callable, Callable]]:
    """``(flax path under params, port key, flax -> port, port -> flax)`` for
    every leaf of the tower and the projector of a ``LlavaConfig``'s
    ``vcfg`` (the tower's config)."""
    d, heads = vcfg.d_model, vcfg.n_heads
    same = lambda x: x  # noqa: E731
    vt = "vision_tower"
    yield (f"{vt}/patch_embed/kernel", f"{vt}.patch_embed.kernel",
           lambda x: x.permute(3, 2, 0, 1), lambda x: x.permute(2, 3, 1, 0))
    if vcfg.patch_bias:
        yield f"{vt}/patch_embed/bias", f"{vt}.patch_embed.bias", same, same
    if vcfg.cls_token:
        yield f"{vt}/cls", f"{vt}.cls", same, same
    yield f"{vt}/pos_embed", f"{vt}.pos_embed", same, same
    norms = (("pre_norm",) if vcfg.pre_norm else ())
    norms += tuple(f"block_{i}/{ln}" for i in range(vcfg.n_run) for ln in ("ln1", "ln2"))
    norms += (("final_norm",) if vcfg.feature_layer == 0 else ())
    port = lambda path: path.replace("block_", "blocks.").replace("/", ".")  # noqa: E731
    for norm in norms:
        for leaf in ("scale", "bias"):
            yield f"{vt}/{norm}/{leaf}", f"{vt}.{port(norm)}.{leaf}", same, same
    to_dd = lambda x: x.reshape(d, d)  # noqa: E731
    flat = lambda x: x.reshape(d)  # noqa: E731
    for i in range(vcfg.n_run):
        blk, pblk = f"{vt}/block_{i}", f"{vt}.blocks.{i}"
        for nm in ("query", "key", "value"):
            yield (f"{blk}/attn/{nm}/kernel", f"{pblk}.attn.{nm}.kernel", to_dd,
                   lambda x: x.reshape(d, heads, d // heads))
            yield (f"{blk}/attn/{nm}/bias", f"{pblk}.attn.{nm}.bias", flat,
                   lambda x: x.reshape(heads, d // heads))
        yield (f"{blk}/attn/out/kernel", f"{pblk}.attn.out.kernel", to_dd,
               lambda x: x.reshape(heads, d // heads, d))
        yield f"{blk}/attn/out/bias", f"{pblk}.attn.out.bias", same, same
        for fc in ("fc1", "fc2"):
            for leaf in ("kernel", "bias"):
                yield f"{blk}/{fc}/{leaf}", f"{pblk}.{fc}.{leaf}", same, same
    for fc in ("projector_fc1", "projector_fc2"):
        for leaf in ("kernel", "bias"):
            yield f"{fc}/{leaf}", f"{fc}.{leaf}", same, same


def from_flax(variables: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """The port's state dict for the reference's ``variables`` (numpy
    leaves).  Raises ``KeyError`` naming the first missing leaf."""
    if getattr(cfg, "vision", None) is None:
        return _text_from_flax(variables, cfg)
    state = _text_from_flax(variables, cfg.text)
    for path, key, to_port, _ in _vision_leaves(cfg.vision):
        leaf = _walk(variables["params"], path)
        if leaf is None:
            raise KeyError(f"flax variables lack params/{path}")
        state[key] = to_port(_tensor(leaf)).contiguous()
    return state


def _text_from_flax(variables: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    params = variables["params"]
    lora = variables.get("lora")
    state: dict[str, torch.Tensor] = {}

    def need(tree, path, where):
        leaf = _walk(tree, path) if tree is not None else None
        if leaf is None:
            raise KeyError(f"flax variables lack {where}/{path}")
        return _tensor(leaf)

    state["embed_tokens.embedding"] = need(params, "embed_tokens/embedding", "params")
    state["final_norm.scale"] = need(params, "final_norm/scale", "params")
    if not cfg.tie_embeddings:
        state["lm_head.kernel"] = need(params, "lm_head/kernel", "params")
    p_layers = _layer_trees(params, cfg.n_layers)
    l_layers = _layer_trees(lora, cfg.n_layers)
    for i, (p, lo) in enumerate(zip(p_layers, l_layers)):
        where = f"params/layer {i}"
        for module, leaves in _layer_leaves(cfg).items():
            name = f"layers.{i}.{module.replace('/', '.')}"
            for leaf in leaves:
                if leaf == "bias" and not cfg.attention_qkv_bias:
                    continue
                state[f"{name}.{leaf}"] = need(p, f"{module}/{leaf}", where)
            proj = module.split("/")[-1]
            if module in _PROJECTIONS and cfg.lora.enabled_for(proj):
                for leaf in ("lora_a", "lora_b"):
                    state[f"{name}.{leaf}"] = need(lo, f"{module}/{leaf}", f"lora/layer {i}")
    if cfg.lora_tenant_slots:
        t_layers = _layer_trees(variables.get("tenants"), cfg.n_layers)
        for module in _PROJECTIONS:
            proj = module.split("/")[-1]
            for leaf in ("lora_a", "lora_b", "scale"):
                per_layer = [need(t, f"{module}/{leaf}", f"tenants/layer {i}")
                             for i, t in enumerate(t_layers)]
                state[f"tenants.{proj}.{leaf}"] = torch.stack(per_layer)
    return state


def adapter_from_flax(lora: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """One adapter's ``lora`` tree (numpy leaves, either layout) as the
    port's flat adapter dict, for every projection the tree holds."""
    adapter: dict[str, torch.Tensor] = {}
    for i, tree in enumerate(_layer_trees(lora, cfg.n_layers)):
        for module in _PROJECTIONS:
            for leaf in ("lora_a", "lora_b"):
                value = _walk(tree, f"{module}/{leaf}") if tree is not None else None
                if value is not None:
                    adapter[f"layers.{i}.{module.replace('/', '.')}.{leaf}"] = _tensor(value)
    return adapter


def to_flax(state: Mapping[str, torch.Tensor], cfg, *,
            leaf: Callable[[torch.Tensor], Any] | None = None) -> dict[str, Any]:
    """The reference's variables tree (``params`` and, with adapters,
    ``lora``) for the port's ``state`` dict, as f32-or-native numpy leaves
    (or ``leaf(tensor)``, e.g. CPU tensors, which keep bf16 without jax's
    numpy type), stacked under ``blocks/block`` when ``cfg.scan_layers``
    else under ``layer_{i}``.  Entries the state lacks are left out."""
    leaf = leaf or _numpy
    if getattr(cfg, "vision", None) is None:
        return _text_to_flax(state, cfg, leaf)
    variables = _text_to_flax(state, cfg.text, leaf)
    for path, key, _, to_flax_leaf in _vision_leaves(cfg.vision):
        if key in state:
            _put(variables["params"], path, leaf(to_flax_leaf(state[key].detach())))
    return variables


def _numpy(t: torch.Tensor):
    """``t`` as a numpy array on the host (bf16 as jax's numpy bf16)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # jax's bf16 numpy type (a test-side conversion)

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _put(tree, path, value):
    *parents, last = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[last] = value


def _text_to_flax(state: Mapping[str, torch.Tensor], cfg,
                  leaf: Callable[[torch.Tensor], Any]) -> dict[str, Any]:
    params: dict[str, Any] = {}
    lora: dict[str, Any] = {}
    for key, path in (("embed_tokens.embedding", "embed_tokens/embedding"),
                      ("final_norm.scale", "final_norm/scale"),
                      ("lm_head.kernel", "lm_head/kernel")):
        if key in state:
            _put(params, path, leaf(state[key]))
    per_layer: list[tuple[dict, dict]] = []
    for i in range(cfg.n_layers):
        p_layer: dict[str, Any] = {}
        l_layer: dict[str, Any] = {}
        for module, leaves in _layer_leaves(cfg).items():
            name = f"layers.{i}.{module.replace('/', '.')}"
            for name_leaf, tree in [(lf, p_layer) for lf in leaves] + [
                    ("lora_a", l_layer), ("lora_b", l_layer)]:
                if f"{name}.{name_leaf}" in state:
                    _put(tree, f"{module}/{name_leaf}", leaf(state[f"{name}.{name_leaf}"]))
        per_layer.append((p_layer, l_layer))

    def stack(trees):
        if isinstance(trees[0], Mapping):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees) if isinstance(trees[0], torch.Tensor) else np.stack(trees)

    for which, out in ((0, params), (1, lora)):
        trees = [layer[which] for layer in per_layer]
        if not trees or not trees[0]:
            continue
        if cfg.scan_layers:
            out["blocks"] = {"block": stack(trees)}
        else:
            for i, tree in enumerate(trees):
                out[f"layer_{i}"] = tree
    variables: dict[str, Any] = {"params": params}
    if lora:
        variables["lora"] = lora
    return variables


def flat_paths(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """``/``-joined paths of a nested dict's leaves (empty dicts vanish)."""
    out: dict[str, Any] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            out.update(flat_paths(tree[key], path))
        else:
            out[path] = tree[key]
    return out


#: top-level groups of a trainer's ``trainable`` tree whose name the port's
#: parameters do not carry (the reference's multimodal and reward trainers
#: hold ``{"lora": ..., "projector": ...}`` / ``{"lora": ..., "head": ...}``)
_UNNAMED_GROUPS = ("lora/", "projector/")


def trainable_from_flax(leaves: Mapping[str, Any]) -> dict[str, Any]:
    """The port's trainable names for a reference trainer's ``trainable``
    leaves, given as ``/``-joined flax paths (:func:`flat_paths`): a LoRA
    collection, a full fine-tune's ``params``, or a grouped tree (the
    ``lora`` and ``projector`` groups dropped, ``head`` kept as
    ``head.*``).  A scanned leaf (``blocks/block/...``) splits along its
    leading layer axis into ``layers.{i}.*``; ``layer_{i}/...`` becomes
    ``layers.{i}.*``.  A leaf is anything indexable along axis 0, or a shape
    tuple (split into ``shape[1:]``).  Leaves outside these layouts keep
    their path with ``.`` for ``/``, so a restore's shape check names them."""
    out: dict[str, Any] = {}
    for path, leaf in leaves.items():
        for group in _UNNAMED_GROUPS:
            if path.startswith(group):
                path = path[len(group):]
                break
        if path.startswith("blocks/block/"):
            rest = path[len("blocks/block/"):].replace("/", ".")
            n = leaf[0] if isinstance(leaf, tuple) else leaf.shape[0]
            for i in range(n):
                out[f"layers.{i}.{rest}"] = leaf[1:] if isinstance(leaf, tuple) else leaf[i]
            continue
        head, _, rest = path.partition("/")
        if head.startswith("layer_") and head[len("layer_"):].isdigit():
            path = f"layers/{head[len('layer_'):]}/{rest}"
        out[path.replace("/", ".")] = leaf
    return out


def merge_kernel(kernel: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """``W + scale·A·B`` computed in f32, in ``kernel``'s dtype."""
    return (kernel.to(torch.float32)
            + (a.to(torch.float32) @ b.to(torch.float32)) * scale).to(kernel.dtype)


def merge_lora(cfg, state: Mapping[str, torch.Tensor]) -> tuple[Any, dict[str, torch.Tensor]]:
    """Fold every adapter into its base kernel: ``W' = W + (alpha/r)·A·B``,
    computed in f32 and cast back to the kernel's dtype.  Returns a rank-0
    config and a state dict without ``lora_a``/``lora_b`` entries.  An
    int4-quantized base cannot absorb a dense delta and is refused."""
    if not any(k.endswith(".lora_a") for k in state):
        return cfg, dict(state)
    if getattr(cfg, "quantize_base", False):
        raise ValueError("cannot merge LoRA into an int4-quantized base; serve unmerged")
    scale = cfg.lora.alpha / cfg.lora.rank
    merged: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if key.endswith((".lora_a", ".lora_b")):
            continue
        prefix = key[: -len(".kernel")] if key.endswith(".kernel") else None
        if prefix is not None and f"{prefix}.lora_a" in state:
            value = merge_kernel(value, state[f"{prefix}.lora_a"], state[f"{prefix}.lora_b"],
                                 scale)
        merged[key] = value
    return merged_config(cfg), merged


def merged_config(cfg):
    """``cfg`` with its adapters folded away (rank 0, same alpha/targets)."""
    return cfg.replace(lora=LoRAConfig(rank=0, alpha=cfg.lora.alpha, targets=cfg.lora.targets))
