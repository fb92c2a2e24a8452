"""Topology manifests of checkpoints (counterpart of ``train/elastic.py``,
its manifest half).

Every committed checkpoint carries a ``manifest.json`` describing the mesh
it was written from, the partition-rule fingerprint, the global batch
semantics and the per-leaf shape/dtype map, in the reference's schema
(``MANIFEST_FORMAT`` 1), so a restore can name a mismatched leaf before it
copies anything and a later multi-card port can plan a resize from it.

The port runs on one card.  Its manifests record ``mesh_axes`` of one
device (every axis of the reference's ``AxisNames.ORDER`` at 1), and its
rule fingerprint is the reference's digest (``ShardingRules.fingerprint``)
of an empty rule table: nothing is partitioned, every leaf lives whole on
the card.  Leaf paths are the ``/``-joined keys of the port's state dict
(``trainable/layers.0.attn.q_proj.lora_a``), the addressing its
checkpoint uses.

Planning a resume onto another mesh (the reference's
``plan_elastic_resume`` and ``largest_feasible_slices``) waits for the
multi-GPU port: :func:`check_single_device_resume` raises
``NotImplementedError`` citing ROADMAP Queue A item 7 where a manifest's
batch decomposition differs from the live one.
"""

from __future__ import annotations

import hashlib
import logging
import math
from typing import Any, Mapping

logger = logging.getLogger(__name__)

#: manifest schema version (bump on incompatible changes)
MANIFEST_FORMAT = 1

#: mesh axes whose product shards the batch dimension (the reference's
#: ``AxisNames.BATCH_AXES``)
_BATCH_AXES = ("dp", "fsdp")

#: the live mesh of the port: one device on every axis of the reference's
#: ``AxisNames.ORDER``
SINGLE_DEVICE_AXES = {"dp": 1, "fsdp": 1, "ep": 1, "pp": 1, "sp": 1, "tp": 1}

#: the reference's fingerprint of an empty rule table: no leaf is partitioned
RULE_FINGERPRINT = f"sha256:{hashlib.sha256(b'').hexdigest()}"


class ElasticManifestError(ValueError):
    """A checkpoint manifest is incompatible with the live trainer (rule
    fingerprint mismatch, unsatisfiable batch decomposition, ...)."""


def _leaf_desc(node: Any) -> dict[str, Any]:
    shape = tuple(getattr(node, "shape", ()) or ())
    dtype = getattr(node, "dtype", None)
    if dtype is None:
        name = type(node).__name__
    else:
        # torch.float32 -> "float32", as numpy names the reference's leaves
        name = str(dtype).removeprefix("torch.")
    return {"shape": list(shape), "dtype": name}


def leaf_entries(host_tree: Any) -> dict[str, dict[str, Any]]:
    """``path -> {shape, dtype}`` over a state tree of nested dicts.

    Paths are the ``/``-joined dict keys, so restore-time validation names
    an offending leaf the way the checkpoint addresses it.
    """
    out: dict[str, dict[str, Any]] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(f"{prefix}/{k}" if prefix else str(k), node[k])
            return
        out[prefix] = _leaf_desc(node)

    walk("", host_tree)
    return out


def build_manifest(
    *,
    step: int,
    mesh_axes: Mapping[str, int],
    rule_fingerprint: str,
    global_batch_size: int,
    grad_accum_steps: int,
    seq_len: int,
    seed: int,
    host_tree: Any,
) -> dict[str, Any]:
    """Assemble the manifest dict the :class:`CheckpointManager` persists
    alongside the state (``manifest.json`` in the committed step dir)."""
    axes = {k: int(v) for k, v in mesh_axes.items()}
    shards = _batch_shards(axes, grad_accum_steps)
    return {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "mesh_axes": axes,
        "rule_fingerprint": rule_fingerprint,
        "global_batch_size": int(global_batch_size),
        "grad_accum_steps": int(grad_accum_steps),
        #: row-shards the global batch was reduced over
        "batch_shards": shards,
        "seq_len": int(seq_len),
        "seed": int(seed),
        "leaves": leaf_entries(host_tree),
    }


def _batch_shards(mesh_axes: Mapping[str, int], grad_accum_steps: int) -> int:
    """Row-groups the global batch is decomposed into: one per batch-axis
    device shard per accumulation microstep."""
    devs = math.prod(int(mesh_axes.get(a, 1)) for a in _BATCH_AXES)
    return max(1, devs) * max(1, int(grad_accum_steps))


def check_fingerprint(manifest: Mapping[str, Any], rule_fingerprint: str) -> None:
    """Refuse a manifest whose partition-rule fingerprint doesn't match the
    live model's rule table — restoring through a different table would
    silently mis-shard the state."""
    have = manifest.get("rule_fingerprint")
    if have and have != rule_fingerprint:
        raise ElasticManifestError(
            f"checkpoint partition-rule fingerprint {have} does not match "
            f"the model's rule table {rule_fingerprint}: the checkpoint was "
            "written under different sharding rules — restore refused "
            "(docs/elasticity.md)"
        )


def check_single_device_resume(manifest: Mapping[str, Any], *, batch_size: int,
                               grad_accum_steps: int) -> None:
    """Accept a manifest whose global batch decomposes on one card exactly
    as it was decomposed when the checkpoint was written.

    The state itself is whole arrays, so any mesh's checkpoint lands on the
    card; what a resume must keep is the gradient microstructure
    (``batch_shards``: batch-axis devices times accumulation steps).  Where
    the written decomposition differs from this run's ``grad_accum_steps``,
    the reference re-plans it (``plan_elastic_resume``), which the port
    does not do yet."""
    source = {k: int(v) for k, v in manifest.get("mesh_axes", {}).items()}
    shards = int(manifest.get("batch_shards") or 0) or _batch_shards(
        source, int(manifest.get("grad_accum_steps", 1)))
    live = _batch_shards(SINGLE_DEVICE_AXES, grad_accum_steps)
    if shards != live:
        raise NotImplementedError(
            f"checkpoint written on mesh {source} reduced the global batch over "
            f"{shards} row-shards, this run over {live} (grad_accum_steps "
            f"{grad_accum_steps} on one card): planning an elastic resume "
            "(plan_elastic_resume) is not ported yet (ROADMAP Queue A item 7, multi-GPU)"
        )
    man_batch = int(manifest.get("global_batch_size") or batch_size)
    if man_batch != batch_size:
        logger.warning(
            "resume: global batch_size changed %d -> %d; the loss trajectory "
            "will not continue the checkpointed run's", man_batch, batch_size)
    if any(v != 1 for v in source.values()):
        logger.info("resume: checkpoint mesh %s -> one card (batch shards preserved)",
                    source)
