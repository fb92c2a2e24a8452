"""Multi-tenant LoRA adapter registry (counterpart of ``serve/adapters.py``).

One base-model fleet serves N fine-tuned tenants by keeping their adapters
unmerged: every projection carries stacked per-tenant ``(A, B, alpha/rank)``
tensors (:class:`~..models.lora.TenantStacks`), and each decode lane applies
its own tenant's adapter through the per-row ``adapter_ids`` vector.

This module owns the host side: slot assignment (slot 0 is the base model,
an all-zero stack whose delta is an exact 0.0), rank padding (tenants train
at different ranks; smaller ones zero-pad to the stack rank), and
:func:`install_into`, which writes or clears one tenant's slot of an
engine's stacks.  Stacks are fixed capacity, so registering a tenant is a
write, never a shape change.

An adapter here is the port's own form: the flat
``{"layers.{i}.{attn|mlp}.{proj}.lora_a": (in, r), ...lora_b: (r, out)}``
dict a LoRA checkpoint's ``trainable`` holds (``models/convert.py``
``adapter_from_flax`` carries a reference ``lora`` tree into it).

One registry serves a whole replica fleet; each replica engine holds its
own stacks and is synced by the fleet on register/unregister, spawn and
rollover (``serve/fleet.py``); a worker process's engine is synced over the
transport's registry-sync RPCs with :func:`entry_to_wire` /
:func:`entry_from_wire`, whose adapter blob is the bytes the reference's
``entry_to_wire`` writes for the same adapter.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch

from ..models.lora import TenantStacks

logger = logging.getLogger(__name__)

#: the layer module each projection lives in
_MODULE = {"q_proj": "attn", "k_proj": "attn", "v_proj": "attn", "o_proj": "attn",
           "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}


class AdapterError(ValueError):
    """Registration refused (capacity, rank, shape mismatch)."""


class UnknownAdapter(ValueError):
    """A request named an adapter this registry has not loaded."""


@dataclasses.dataclass
class AdapterEntry:
    adapter_id: str
    slot: int
    tree: Any                     # the adapter dict (CPU tensors)
    alpha: float
    rank: int
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def install_into(stacks: TenantStacks, slot: int, adapter_tree: dict | None,
                 alpha: float, rank: int) -> None:
    """Write one tenant's (rank-padded) adapter into stack slot ``slot``;
    ``adapter_tree=None`` clears the slot (zero stack, scale 0).

    Every leaf is padded and checked on the host first, so a refused
    adapter (:class:`AdapterError`) leaves the stacks untouched; only then
    are the slot's rows written, in place.  The caller makes sure no forward
    reads ``stacks`` meanwhile (``BatchEngine`` holds its lock).  Padding is
    done in f32 and cast to the stacks' dtype, as the reference pads in f32
    and casts at use.  Projections the adapter does not target stay zero:
    their delta is an exact 0.0.
    """
    rows = {}
    for name, stack in stacks.named_children():
        n_layers, _, fan_in, r_max = stack.lora_a.shape
        fan_out = stack.lora_b.shape[-1]
        a_pad = torch.zeros((n_layers, fan_in, r_max), dtype=torch.float32)
        b_pad = torch.zeros((n_layers, r_max, fan_out), dtype=torch.float32)
        for i in range(n_layers if adapter_tree is not None else 0):
            prefix = f"layers.{i}.{_MODULE[name]}.{name}"
            for leaf, pad in (("lora_a", a_pad), ("lora_b", b_pad)):
                value = adapter_tree.get(f"{prefix}.{leaf}")
                if value is None:
                    continue
                value = torch.as_tensor(value, dtype=torch.float32)
                try:
                    if leaf == "lora_a":     # (in, r) -> (in, R)
                        pad[i, :, : value.shape[-1]] = value
                    else:                    # (r, out) -> (R, out)
                        pad[i, : value.shape[-2], :] = value
                except (RuntimeError, IndexError) as e:
                    slot_shape = tuple(pad.shape[1:])
                    raise AdapterError(
                        f"adapter leaf {prefix}.{leaf} shape {tuple(value.shape)} does not fit "
                        f"stack slot {slot_shape} (wrong base model or rank > stack rank?): {e}"
                    ) from None
        scale = (alpha / rank) if adapter_tree is not None else 0.0
        rows[name] = (a_pad, b_pad, scale)
    with torch.no_grad():
        for name, stack in stacks.named_children():
            a_pad, b_pad, scale = rows[name]
            stack.lora_a[:, slot] = a_pad.to(stack.lora_a.device, stack.lora_a.dtype)
            stack.lora_b[:, slot] = b_pad.to(stack.lora_b.device, stack.lora_b.dtype)
            stack.scale[:, slot] = torch.tensor(scale, dtype=torch.float32).to(stack.scale.dtype)


class AdapterRegistry:
    """Slot assignment + host copies for one served base model.

    ``capacity`` counts stack slots INCLUDING the reserved base slot 0, so a
    registry built from ``serve_max_adapters=4`` has capacity 5.
    """

    def __init__(self, capacity: int, max_rank: int):
        if capacity < 2:
            raise ValueError("adapter registry needs capacity >= 2 "
                             "(slot 0 is the base model)")
        if max_rank < 1:
            raise ValueError("adapter stack rank must be >= 1")
        self.capacity = int(capacity)
        self.max_rank = int(max_rank)
        self._entries: dict[str, AdapterEntry] = {}
        self._free_slots = list(range(self.capacity - 1, 0, -1))

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    def resolve(self, adapter_id: str) -> int:
        """Stack slot for ``adapter_id`` ('' = the base model, slot 0)."""
        if not adapter_id:
            return 0
        entry = self._entries.get(adapter_id)
        if entry is None:
            raise UnknownAdapter(
                f"adapter {adapter_id!r} is not loaded on this fleet "
                f"(loaded: {sorted(self._entries) or 'none'})"
            )
        return entry.slot

    def get(self, adapter_id: str) -> AdapterEntry | None:
        return self._entries.get(adapter_id)

    def entries(self) -> list[AdapterEntry]:
        return sorted(self._entries.values(), key=lambda e: e.slot)

    def register(self, adapter_id: str, lora_tree: Any, alpha: float,
                 rank: int, meta: dict[str, Any] | None = None) -> AdapterEntry:
        """Assign (or re-use, for a tenant checkpoint rollover) a slot and
        record the host copy.  Device installation is the fleet's job —
        every replica engine applies :func:`install_into` with this entry."""
        if not adapter_id:
            raise AdapterError("adapter id must be non-empty")
        if rank < 1 or rank > self.max_rank:
            raise AdapterError(
                f"adapter rank {rank} outside [1, {self.max_rank}] "
                f"(raise serve_adapter_rank to stack higher ranks)"
            )
        existing = self._entries.get(adapter_id)
        if existing is not None:
            slot = existing.slot  # in-place refresh: tenant rollover
        elif self._free_slots:
            slot = self._free_slots.pop()
        else:
            raise AdapterError(
                f"adapter registry full ({self.capacity - 1} tenant slots); "
                "unload an adapter or raise serve_max_adapters"
            )
        entry = AdapterEntry(
            adapter_id=adapter_id, slot=slot, tree=lora_tree,
            alpha=float(alpha), rank=int(rank), meta=dict(meta or {}),
        )
        self._entries[adapter_id] = entry
        logger.info("adapter %s registered in slot %d (rank %d, alpha %s)",
                    adapter_id, slot, rank, alpha)
        return entry

    def unregister(self, adapter_id: str) -> AdapterEntry:
        entry = self._entries.pop(adapter_id, None)
        if entry is None:
            raise UnknownAdapter(f"adapter {adapter_id!r} is not loaded")
        self._free_slots.append(entry.slot)
        logger.info("adapter %s unregistered (slot %d freed)",
                    adapter_id, entry.slot)
        return entry

    def stats(self) -> dict[str, Any]:
        return {
            "capacity": self.capacity - 1,
            "loaded": len(self._entries),
            "adapters": {
                e.adapter_id: {"slot": e.slot, "rank": e.rank,
                               "alpha": e.alpha, **e.meta}
                for e in self.entries()
            },
        }


# ---------------------------------------------------------------------------
# Wire serialization (transport/: the registry-sync RPC)
# ---------------------------------------------------------------------------


def adapter_to_flax(adapter: dict[str, Any]) -> dict[str, Any]:
    """The port's flat adapter dict as the reference's ``lora`` tree in its
    default scanned layout: ``blocks/block/{attn|mlp}/{proj}/lora_a|b`` with
    a leading layer axis (the inverse of ``models/convert.py``'s
    ``adapter_from_flax``)."""
    layers: dict[int, dict[str, Any]] = {}
    for key, value in adapter.items():
        _, i, module, proj, leaf = key.split(".")
        layers.setdefault(int(i), {})[f"{module}/{proj}/{leaf}"] = value
    if sorted(layers) != list(range(len(layers))):
        raise AdapterError(f"adapter layers {sorted(layers)} are not 0..{len(layers) - 1}")
    block: dict[str, Any] = {}
    for path in layers[0]:
        module, proj, leaf = path.split("/")
        stacked = torch.stack([torch.as_tensor(layers[i][path]).detach().cpu()
                               for i in range(len(layers))])
        block.setdefault(module, {}).setdefault(proj, {})[leaf] = stacked
    return {"blocks": {"block": block}}


def adapter_from_flax_tree(lora: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A reference ``lora`` tree (scanned ``blocks/block`` or ``layer_{i}``)
    as the port's flat adapter dict of CPU tensors."""
    def leaves(tree, prefix=""):
        for key, value in tree.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                yield from leaves(value, path)
            else:
                yield path, value

    def tensor(x) -> torch.Tensor:
        return x.clone() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))

    out: dict[str, torch.Tensor] = {}
    if "blocks" in lora:
        for path, value in leaves(lora["blocks"]["block"]):
            for i in range(value.shape[0]):
                out[f"layers.{i}.{path.replace('/', '.')}"] = tensor(value[i])
        return out
    for path, value in leaves(lora):
        layer, _, rest = path.partition("/")
        out[f"layers.{layer.removeprefix('layer_')}.{rest.replace('/', '.')}"] = tensor(value)
    return out


def entry_to_wire(entry: AdapterEntry) -> dict[str, Any]:
    """Serialize one registry entry for the worker registry-sync RPC: the
    adapter rides as a flax-msgpack blob of the reference's ``lora`` tree
    layout — megabytes of deltas, never model weights."""
    from ..transport.wire import tree_to_blob

    return {
        "adapter_id": entry.adapter_id,
        "alpha": float(entry.alpha),
        "rank": int(entry.rank),
        "meta": dict(entry.meta),
        "tree": tree_to_blob(adapter_to_flax(entry.tree)),
    }


def entry_from_wire(doc: dict[str, Any]) -> tuple[str, Any, float, int, dict]:
    """Inverse of :func:`entry_to_wire` → ``(adapter_id, adapter, alpha,
    rank, meta)``, the :meth:`AdapterRegistry.register` argument shape."""
    from ..transport.wire import tree_from_blob

    adapter = adapter_from_flax_tree(tree_from_blob(doc["tree"]))
    return (
        str(doc["adapter_id"]), adapter, float(doc["alpha"]), int(doc["rank"]),
        dict(doc.get("meta") or {}),
    )
